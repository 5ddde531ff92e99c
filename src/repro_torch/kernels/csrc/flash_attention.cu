// Flash attention forward (K6): online-softmax attention of q (B, H, S, D)
// against k, v (B, KV, T, D), causal and/or sliding-window band, grouped
// query heads, output (B, H, S, D) in q's type.
//
// repro_flash_attention replaces the Pallas kernel
// src/repro/kernels/flash_attention.py (_flash_kernel /
// flash_attention_bhsd).  It computes the same function: scores q.k / sqrt(D)
// in float32, masked from global row and column indices (causal: col <= row;
// window w > 0: col > row - w), a running max, denominator and accumulator in
// float32, P.V in float32, and acc / max(l, 1e-30) at the end.  Query head h
// reads key/value head h * KV / H; no repeat is materialised.
//
// Bound on this card: operations.  At gemma3-1b's prefill shape (4 x 4 x 2048
// x 256 against one KV head) a causal layer does about 34 GFLOP on the
// unmasked pairs and moves about 42 MB.  Design (simple first, on CUDA
// cores): the TPU's sequential "arbitrary" k-grid axis becomes a loop inside
// the block; one block of 256 threads owns one (b, h, 64-row q tile) and walks
// the 64-column k tiles that intersect its causal band and window, skipping
// the rest.  The Q tile and one K or V tile sit in dynamic shared memory in
// the input type (rows padded to an odd number of 32-bit words, so column
// reads are free of bank conflicts); the 64 x 64 score tile is float32 in
// shared memory; each thread keeps a 4 x (DMAX/16) slice of the accumulator
// in registers.  The ragged S and T edges are masked here, so no padded copy
// of the inputs is made.  Every input row may have any stride; only the head
// dimension must be contiguous, so the model's (B, S, H, D) activations are
// read in place.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;          // q rows per block
constexpr int kBK = 64;          // k columns per tile
constexpr int kThreads = 256;    // 16 x 16 thread grid
constexpr int kSP = kBK + 1;     // score-tile row stride (floats)

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int64_t B, H, KV, S, T, D;
  int64_t q_sb, q_sh, q_ss;
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_ss;
  int64_t window;
  float scale;
  int causal;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// shared-memory row stride in elements: an odd number of 32-bit words
template <typename T>
__host__ __device__ constexpr int row_stride(int d) {
  return d + (sizeof(T) == 2 ? 2 : 1);
}

template <typename T>
constexpr size_t smem_bytes(int d) {
  return 2 * (size_t)kBQ * row_stride<T>(d) * sizeof(T) +
         ((size_t)kBQ * kSP + 2 * kBQ) * sizeof(float);
}

// Copies rows [r0, r0 + kBQ) of one (rows, D) head slice into shared memory,
// zero-filling rows at or beyond n_rows.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int64_t r0,
                                          int64_t n_rows, int64_t stride,
                                          int d, int ld) {
  for (int idx = threadIdx.x; idx < kBQ * d; idx += kThreads) {
    const int r = idx / d;
    const int c = idx - r * d;
    const int64_t g = r0 + r;
    dst[r * ld + c] = g < n_rows ? src[g * stride + c] : from_float<T>(0.0f);
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads) flash_kernel(const Params p) {
  constexpr int NJ = DMAX / 16;  // accumulator columns per thread
  extern __shared__ __align__(16) unsigned char smem[];
  const int d = (int)p.D;
  const int ld = row_stride<T>(d);
  T* q_s = reinterpret_cast<T*>(smem);
  T* kv_s = q_s + kBQ * ld;
  float* s_s = reinterpret_cast<float*>(kv_s + kBK * ld);
  float* alpha_s = s_s + kBQ * kSP;
  float* l_s = alpha_s + kBQ;

  const int tid = threadIdx.x;
  const int tx = tid & 15;   // column group (S and accumulator)
  const int ty = tid >> 4;   // row group: rows ty + 16 i
  const int sr = tid >> 2;   // softmax row
  const int sp = tid & 3;    // softmax quarter of that row
  const int64_t q0 = (int64_t)blockIdx.x * kBQ;
  const int64_t h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int64_t kvh = h * p.KV / p.H;
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  T* og = static_cast<T*>(p.out) + b * p.o_sb + h * p.o_sh;

  load_tile<T>(q_s, qg, q0, p.S, p.q_ss, d, ld);

  // k tiles that intersect this q tile's band
  const int64_t q_last = (q0 + kBQ < p.S ? q0 + kBQ : p.S) - 1;
  int64_t k_begin = 0;
  int64_t k_end = p.T;
  if (p.causal && q_last + 1 < k_end) k_end = q_last + 1;
  if (p.window > 0 && q0 - p.window + 1 > 0) k_begin = q0 - p.window + 1;
  const int64_t kt_begin = k_begin / kBK;
  const int64_t kt_end = (k_end + kBK - 1) / kBK;

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
  float m_run = -INFINITY;  // replicated over the row's four threads
  float l_run = 0.0f;

  for (int64_t kt = kt_begin; kt < kt_end; ++kt) {
    const int64_t k0 = kt * kBK;
    __syncthreads();  // the previous tile's P.V is done with kv_s and s_s
    load_tile<T>(kv_s, kg, k0, p.T, p.k_ss, d, ld);
    __syncthreads();

    // scores: a 4 x 4 micro-tile per thread, rows ty + 16 i, cols tx + 16 j
    float sacc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sacc[i][j] = 0.0f;
    for (int c = 0; c < d; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = to_float(q_s[(ty + 16 * i) * ld + c]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = to_float(kv_s[(tx + 16 * j) * ld + c]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sacc[i][j] += qv[i] * kv[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t col = k0 + tx + 16 * j;
        const bool ok = col < p.T && (!p.causal || col <= row) &&
                        (p.window <= 0 || col > row - p.window);
        s_s[(ty + 16 * i) * kSP + tx + 16 * j] =
            ok ? sacc[i][j] * p.scale : -INFINITY;
      }
    }
    __syncthreads();

    // V replaces K in shared memory while the rows go through the softmax
    load_tile<T>(kv_s, vg, k0, p.T, p.v_ss, d, ld);
    float* srow = s_s + sr * kSP + sp * 16;
    float mx = -INFINITY;
#pragma unroll
    for (int t = 0; t < 16; ++t) mx = fmaxf(mx, srow[t]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run, mx);
    float alpha = 1.0f;
    float sum = 0.0f;
    if (m_new == -INFINITY) {  // nothing of this row visible yet
#pragma unroll
      for (int t = 0; t < 16; ++t) srow[t] = 0.0f;
    } else {
      alpha = expf(m_run - m_new);
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        const float e = srow[t] == -INFINITY ? 0.0f : expf(srow[t] - m_new);
        srow[t] = e;
        sum += e;
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l_run = l_run * alpha + sum;
    m_run = m_new;
    if (sp == 0) alpha_s[sr] = alpha;
    __syncthreads();

    // acc = acc * alpha + P.V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = alpha_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= a;
    }
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = s_s[(ty + 16 * i) * kSP + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = tx + 16 * j;
        if (c < d) {
          const float vv = to_float(kv_s[kk * ld + c]);
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] += pv[i] * vv;
        }
      }
    }
  }

  if (sp == 0) l_s[sr] = l_run;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int64_t row = q0 + r;
    if (row >= p.S) continue;
    const float denom = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < d) og[row * p.o_ss + c] = from_float<T>(acc[i][j] / denom);
    }
  }
}

template <typename T, int DMAX>
int launch(const Params& p, cudaStream_t s) {
  // shared memory above 48 KB must be allowed once per kernel
  static const int attr_err = (int)cudaFuncSetAttribute(
      flash_kernel<T, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes<T>(DMAX));
  if (attr_err != 0) return attr_err;
  const dim3 grid((unsigned int)((p.S + kBQ - 1) / kBQ), (unsigned int)p.H,
                  (unsigned int)p.B);
  flash_kernel<T, DMAX>
      <<<grid, kThreads, smem_bytes<T>((int)p.D), s>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Params& p, cudaStream_t s) {
  if (p.D <= 64) return launch<T, 64>(p, s);
  if (p.D <= 128) return launch<T, 128>(p, s);
  return launch<T, 256>(p, s);
}

}  // namespace

// dtype: 0 -> float32, 1 -> bfloat16 (q, k, v and out share it).  Strides
// are in elements: (batch, head, row) for each tensor; the head dimension is
// contiguous.  D must be a multiple of 4 and at most 256.
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* out, int64_t B,
    int64_t H, int64_t KV, int64_t S, int64_t T, int64_t D,
    const int64_t* strides, int causal, int64_t window, float scale,
    int dtype, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return 0;
  if (T <= 0 || KV <= 0 || H % KV != 0 || D <= 0 || D > 256 || D % 4 != 0 ||
      H > 65535 || B > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.B = B;
  p.H = H;
  p.KV = KV;
  p.S = S;
  p.T = T;
  p.D = D;
  p.q_sb = strides[0];
  p.q_sh = strides[1];
  p.q_ss = strides[2];
  p.k_sb = strides[3];
  p.k_sh = strides[4];
  p.k_ss = strides[5];
  p.v_sb = strides[6];
  p.v_sh = strides[7];
  p.v_ss = strides[8];
  p.o_sb = strides[9];
  p.o_sh = strides[10];
  p.o_ss = strides[11];
  p.window = window;
  p.scale = scale;
  p.causal = causal;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return dispatch<float>(p, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(p, s);
  return (int)cudaErrorInvalidValue;
}
