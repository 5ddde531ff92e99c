// Flash attention forward (K6): online-softmax attention of q (B, H, S, D)
// against k, v (B, KV, T, D), causal and/or sliding-window band, grouped
// query heads, output (B, H, S, D) in q's type.
//
// repro_flash_attention replaces the Pallas kernel
// src/repro/kernels/flash_attention.py (_flash_kernel /
// flash_attention_bhsd).  It computes the same function: scores q.k / sqrt(D)
// accumulated in float32, masked from global row and column indices (causal:
// col <= row; window w > 0: col > row - w), a running max, denominator and
// accumulator in float32, and acc / max(l, 1e-30) at the end, cast to q's
// type.  Query head h reads key/value head h * KV / H; no repeat is
// materialised.  The ragged S and T edges are masked here, so no padded copy
// is made, and every input row may have any stride with the head dimension
// contiguous, so the model's (B, S, H, D) activations are read in place and
// the output is written through its own strides.
//
// Bound on this card: operations.  At gemma3-1b's prefill shape (4 x 4 x 2048
// x 256 against one KV head) a causal layer does 34.4 GFLOP on the unmasked
// pairs and moves about 42 MB, some 820 operations a byte against the card's
// 295 at bf16 tensor-core rate.  The type picks one of two kernels; neither
// stands in for the other:
//
// flash_wgmma_kernel (bfloat16; D a multiple of 16 up to 256).  Both
// products run on the tensor cores as Hopper warpgroup MMAs (wgmma).  A block
// owns 128 q rows of one (b, h) and walks the 64-column k tiles that meet
// its causal band and window, skipping the rest.  It has three warpgroups.
// The producer: one thread issues every copy as a TMA box load (K and V of
// a tile, Q once), one tile ahead, into a ring of two K/V stages, each
// stage signalled by a "full" mbarrier when its bytes land and refilled
// once the consumers' "empty" mbarrier says both are done with it; its
// warpgroup gives its registers to the consumers (setmaxnreg).  Two
// consumer warpgroups of 64 q rows each: they wait on "full" and run
// independently of each other, so one's softmax can overlap the other's
// products; a warpgroup whose own band misses a tile skips its products.
// TMA writes each tile as 128-byte swizzled rows (64 head-dimension columns
// an atom), the layout wgmma's 128B-swizzle descriptors read without bank
// conflicts, and fills rows past S or T and columns past D with zeros.
// S = Q.K^T is a wgmma with Q and K from shared memory (m64n64k16 steps over
// D); the scores stay in registers, where the mask, the running max and the
// exponentials (exp2 of log2-scaled scores) are applied; P is rounded to
// bfloat16 in registers and is the register A operand of O += P.V, whose B
// operand is the V tile read transposed from shared memory.  Neither S nor
// P touches shared memory.  The row sum l adds P after its rounding to
// bfloat16, so the weights that multiply V are the ones that are summed.
// Each consumer thread holds two rows' worth of the float32 O accumulator
// (D / 2 registers).  Causal q tiles are launched longest first, so the
// grid's tail is short.
//
// flash_simt_kernel (float32; D a multiple of 4 up to 256).  Tensor cores
// offer float32 only as TF32, which would break the float32 checks, so the
// float32 path stays on CUDA cores: one block of 256 threads owns one
// (b, h, 64-row q tile); the Q tile and one K or V tile sit in shared memory
// (rows padded to an odd number of 32-bit words, so column reads are free of
// bank conflicts), the 64 x 64 score tile is float32 in shared memory, and
// each thread keeps a 4 x (DMAX/16) slice of the accumulator in registers;
// P.V is float32.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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

// ---------------------------------------------------------------------------
// float32 on CUDA cores
// ---------------------------------------------------------------------------

namespace simt {

constexpr int kBQ = 64;          // q rows per block
constexpr int kBK = 64;          // k columns per tile
constexpr int kThreads = 256;    // 16 x 16 thread grid
constexpr int kSP = kBK + 1;     // score-tile row stride (floats)

// shared-memory row stride in floats: an odd number of 32-bit words
__host__ __device__ constexpr int row_stride(int d) { return d + 1; }

constexpr size_t smem_bytes(int d) {
  return 2 * (size_t)kBQ * row_stride(d) * sizeof(float) +
         ((size_t)kBQ * kSP + 2 * kBQ) * sizeof(float);
}

// Copies rows [r0, r0 + kBQ) of one (rows, D) head slice into shared memory,
// zero-filling rows at or beyond n_rows.
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int64_t r0, int64_t n_rows,
                                          int64_t stride, int d, int ld) {
  for (int idx = threadIdx.x; idx < kBQ * d; idx += kThreads) {
    const int r = idx / d;
    const int c = idx - r * d;
    const int64_t g = r0 + r;
    dst[r * ld + c] = g < n_rows ? src[g * stride + c] : 0.0f;
  }
}

template <int DMAX>
__global__ void __launch_bounds__(kThreads) flash_simt_kernel(const Params p) {
  constexpr int NJ = DMAX / 16;  // accumulator columns per thread
  extern __shared__ __align__(16) unsigned char smem[];
  const int d = (int)p.D;
  const int ld = row_stride(d);
  float* q_s = reinterpret_cast<float*>(smem);
  float* kv_s = q_s + kBQ * ld;
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
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg =
      static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* vg =
      static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  float* og = static_cast<float*>(p.out) + b * p.o_sb + h * p.o_sh;

  load_tile(q_s, qg, q0, p.S, p.q_ss, d, ld);

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
    load_tile(kv_s, kg, k0, p.T, p.k_ss, d, ld);
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
        qv[i] = q_s[(ty + 16 * i) * ld + c];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = kv_s[(tx + 16 * j) * ld + c];
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
    load_tile(kv_s, vg, k0, p.T, p.v_ss, d, ld);
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
          const float vv = kv_s[kk * ld + c];
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
      if (c < d) og[row * p.o_ss + c] = acc[i][j] / denom;
    }
  }
}

template <int DMAX>
int launch(const Params& p, cudaStream_t s) {
  // shared memory above 48 KB must be allowed once per kernel
  static const int attr_err = (int)cudaFuncSetAttribute(
      flash_simt_kernel<DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes(DMAX));
  if (attr_err != 0) return attr_err;
  const dim3 grid((unsigned int)((p.S + kBQ - 1) / kBQ), (unsigned int)p.H,
                  (unsigned int)p.B);
  flash_simt_kernel<DMAX><<<grid, kThreads, smem_bytes((int)p.D), s>>>(p);
  return (int)cudaGetLastError();
}


int dispatch(const Params& p, cudaStream_t s) {
  if (p.D <= 64) return launch<64>(p, s);
  if (p.D <= 128) return launch<128>(p, s);
  return launch<256>(p, s);
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores (wgmma)
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kBM = 128;       // q rows per block, 64 per consumer warpgroup
constexpr int kBN = 64;        // k columns per tile
constexpr int kThreads = 384;  // a producer warpgroup and two consumers
constexpr int kRow = 128;      // bytes of one swizzled row: 64 bf16 columns

// Shared memory of one block, every tile 1024-byte aligned (the period of
// the 128-byte swizzle): Q as DMAX/64 atoms of kBM rows, two stages of a K
// tile and a V tile, each DMAX/64 atoms of kBN rows, then five mbarriers.
template <int DMAX>
struct Smem {
  static constexpr int kQBytes = kBM * DMAX * 2;
  static constexpr int kTileBytes = kBN * DMAX * 2;
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kBytes = kQBytes + 2 * kStageBytes + 64 + 1024;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accesses of accumulator registers across
// the asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (all in 16-byte units), layout type 1 (B128).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

#define FA_ACC32(d)                                                         \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])
#define FA_REGS32                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d (64 x 64, float32) (+)= A (64 x 16) . B (16 x 64): A and B from shared
// memory, both K-major (16 contiguous elements of the product's depth a row)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FA_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : FA_ACC32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64, float32) += A (64 x 16, bf16 pairs in registers) . B (16 x 64)
// with B from shared memory, N-major (read transposed)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FA_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : FA_ACC32(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

#undef FA_ACC32
#undef FA_REGS32

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// mbarriers in shared memory: `count` arrivals (plus, after expect_tx, the
// bytes of the copies that complete on it) end a phase; waits name the
// parity of the phase they wait for
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// a box of a 4-d tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// q, k and v as (D, rows, heads, batch) tensor maps: boxes of 64 columns
// by kBM (q) or kBN (k, v) rows, 128-byte swizzle, rows past S or T and
// columns past D filled with zeros
struct TmaParams {
  CUtensorMap q, k, v;
  Params p;
};

template <int DMAX>
__global__ void __launch_bounds__(kThreads, 1)
    flash_wgmma_kernel(const __grid_constant__ TmaParams tp) {
  using L = Smem<DMAX>;
  constexpr int kAtoms = DMAX / 64;
  const Params& p = tp.p;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t kv_s = base + L::kQBytes;  // stage s: K, then V
  // mbarriers: Q landed; stage s landed (full), stage s free (empty)
  const uint32_t q_full = kv_s + 2 * L::kStageBytes;
  const uint32_t full0 = q_full + 8;    // full[s] = full0 + 8 s
  const uint32_t empty0 = q_full + 24;  // empty[s] = empty0 + 8 s

  const int tid = threadIdx.x;
  const int wg = tid >> 7;  // 0: producer, 1 and 2: consumers

  // longest causal rows first: the q tile varies slowest over the grid
  const int64_t n_qt = (p.S + kBM - 1) / kBM;
  const int64_t n_bh = p.B * p.H;
  int64_t qt = (int64_t)blockIdx.x / n_bh;
  const int64_t bh = (int64_t)blockIdx.x - qt * n_bh;
  if (p.causal) qt = n_qt - 1 - qt;
  const int64_t b = bh / p.H;
  const int64_t h = bh - b * p.H;
  const int64_t kvh = h * p.KV / p.H;
  const int64_t q0 = qt * kBM;

  // k tiles that meet the block's band
  const int64_t q_last = (q0 + kBM < p.S ? q0 + kBM : p.S) - 1;
  int64_t k_begin = 0;
  int64_t k_end = p.T;
  if (p.causal && q_last + 1 < k_end) k_end = q_last + 1;
  if (p.window > 0 && q0 - p.window + 1 > 0) k_begin = q0 - p.window + 1;
  const int64_t kt_begin = k_begin / kBN;
  const int n_tiles = (int)((k_end + kBN - 1) / kBN - kt_begin);

  if (tid == 0) {
    mbar_init(q_full, 1);
    mbar_init(full0, 1);
    mbar_init(full0 + 8, 1);
    mbar_init(empty0, 8);  // one arrival per consumer warp
    mbar_init(empty0 + 8, 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread issues every TMA copy, one tile ahead of the
    // consumers (two stages); its warpgroup hands its registers over
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 0) {
      mbar_expect_tx(q_full, kAtoms * kBM * kRow);
      for (int a = 0; a < kAtoms; ++a) {
        tma_load_4d(q_s + a * kBM * kRow, &tp.q, q_full, 64 * a, (int)q0,
                    (int)h, (int)b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it & 1;
        mbar_wait(empty0 + 8 * st, ((it >> 1) & 1) ^ 1);  // stage free
        const uint32_t k_st = kv_s + st * L::kStageBytes;
        const int k0 = (int)((kt_begin + it) * kBN);
        mbar_expect_tx(full0 + 8 * st, 2 * kAtoms * kBN * kRow);
        for (int a = 0; a < kAtoms; ++a) {
          tma_load_4d(k_st + a * kBN * kRow, &tp.k, full0 + 8 * st, 64 * a,
                      k0, (int)kvh, (int)b);
        }
        for (int a = 0; a < kAtoms; ++a) {
          tma_load_4d(k_st + L::kTileBytes + a * kBN * kRow, &tp.v,
                      full0 + 8 * st, 64 * a, k0, (int)kvh, (int)b);
        }
      }
    }
  } else {
    // consumers: 64 q rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cwg = wg - 1;
    const int warp = (tid >> 5) & 3;  // warp within it: 16 rows each
    const int lane = tid & 31;
    const int qd = lane & 3;          // column pair within an 8-column group
    const int d = (int)p.D;
    __nv_bfloat16* og =
        static_cast<__nv_bfloat16*>(p.out) + b * p.o_sb + h * p.o_sh;
    // this warpgroup's rows [w0, w_last] and the columns its band can see
    const int64_t w0 = q0 + 64 * cwg;
    const int64_t w_last = (w0 + 64 < p.S ? w0 + 64 : p.S) - 1;
    int64_t wk_begin = 0;
    int64_t wk_end = p.T;
    if (p.causal && w_last + 1 < wk_end) wk_end = w_last + 1;
    if (p.window > 0 && w0 - p.window + 1 > 0) wk_begin = w0 - p.window + 1;
    // the thread's two rows: row0 and row0 + 8
    const int64_t row0 = w0 + 16 * warp + (lane >> 2);

    float o[kAtoms][32];
#pragma unroll
    for (int a = 0; a < kAtoms; ++a)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[a][i] = 0.0f;
    float m_run[2] = {-INFINITY, -INFINITY};  // log2-scaled running max
    float l_run[2] = {0.0f, 0.0f};  // this thread's share of the row sums
    const float scale_log2 = p.scale * 1.4426950408889634f;
    const uint32_t q_wg = q_s + cwg * 64 * kRow;
    const int n_k16 = d >> 4;
    mbar_wait(q_full, 0);

    for (int it = 0; it < n_tiles; ++it) {
      const int st = it & 1;
      const uint32_t k_st = kv_s + st * L::kStageBytes;
      const uint32_t v_st = k_st + L::kTileBytes;
      // wait even for a tile this warpgroup skips, so the parity of the
      // stage's barrier stays in step
      mbar_wait(full0 + 8 * st, (it >> 1) & 1);
      const int64_t k0 = (kt_begin + it) * kBN;
      if (w0 < p.S && k0 < wk_end && k0 + kBN > wk_begin) {
        // S = Q . K^T over D in steps of 16
        float s[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = 0.0f;
        fence_regs(s);
        wgmma_fence();
        for (int kk = 0; kk < n_k16; ++kk) {
          const uint32_t col = (kk & 3) * 32;  // 16 columns: 32 bytes
          wgmma_ss(s,
                   sw128_desc(q_wg + (kk >> 2) * (kBM * kRow) + col, 16,
                              1024),
                   sw128_desc(k_st + (kk >> 2) * (kBN * kRow) + col, 16,
                              1024),
                   kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(s);

        // mask (only on tiles that cross an edge of the band), running max
        const bool edge = k0 + kBN > p.T ||
                          (p.causal && k0 + kBN - 1 > w0) ||
                          (p.window > 0 && k0 <= w_last - p.window);
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          // visible columns of this row, relative to k0: [lo, hi]
          int lo = 0;
          int hi = kBN - 1;
          if (edge) {
            const int64_t row = row0 + 8 * r;
            int64_t h64 = p.T - 1;
            if (p.causal && row < h64) h64 = row;
            int64_t l64 = p.window > 0 ? row - p.window + 1 : 0;
            h64 -= k0;
            l64 -= k0;
            hi = (int)(h64 < -1 ? -1 : (h64 > kBN ? kBN : h64));
            lo = (int)(l64 < 0 ? 0 : (l64 > kBN ? kBN : l64));
          }
#pragma unroll
          for (int c = 0; c < 8; ++c) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = 8 * c + 2 * qd + e;
              float v = s[4 * c + 2 * r + e] * scale_log2;
              if (col < lo || col > hi) v = -INFINITY;
              s[4 * c + 2 * r + e] = v;
              mx[r] = fmaxf(mx[r], v);
            }
          }
        }
        float alpha[2];
        float base_[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m_run[r], mx[r]);
          // a row that sees nothing yet keeps P, O and l at zero
          base_[r] = m_new == -INFINITY ? 0.0f : m_new;
          alpha[r] = exp2f(m_run[r] - base_[r]);
          m_run[r] = m_new;
        }
        // P in bfloat16, as the A operand of P.V: registers 4kk..4kk+3 hold
        // columns 16kk..16kk+15 in the m16n8k16 A-fragment order; l adds
        // P after its rounding
        uint32_t pa[16];
        float rs[2] = {0.0f, 0.0f};
#pragma unroll
        for (int c = 0; c < 8; ++c) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const __nv_bfloat162 pr = __floats2bfloat162_rn(
                exp2f(s[4 * c + 2 * r] - base_[r]),
                exp2f(s[4 * c + 2 * r + 1] - base_[r]));
            rs[r] += __low2float(pr) + __high2float(pr);
            pa[2 * c + r] = bf16x2_bits(pr);
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rs[r];
#pragma unroll
        for (int a = 0; a < kAtoms; ++a) {
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            o[a][4 * c + 0] *= alpha[0];
            o[a][4 * c + 1] *= alpha[0];
            o[a][4 * c + 2] *= alpha[1];
            o[a][4 * c + 3] *= alpha[1];
          }
        }
        // O += P . V over the tile's 64 keys in steps of 16
#pragma unroll
        for (int a = 0; a < kAtoms; ++a) fence_regs(o[a]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBN / 16; ++kk) {
#pragma unroll
          for (int a = 0; a < kAtoms; ++a) {
            wgmma_rs(o[a], pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                     pa[4 * kk + 3],
                     sw128_desc(v_st + a * (kBN * kRow) + kk * 16 * kRow,
                                kBN * kRow, 1024));
          }
        }
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int a = 0; a < kAtoms; ++a) fence_regs(o[a]);
      }
      if (lane == 0) mbar_arrive(empty0 + 8 * st);  // this warp is done
    }

    // O / l, written as bfloat16 pairs
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float denom = fmaxf(l, 1e-30f);
      const int64_t row = row0 + 8 * r;
      if (row >= p.S) continue;
      __nv_bfloat16* orow = og + row * p.o_ss;
#pragma unroll
      for (int a = 0; a < kAtoms; ++a) {
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int col = 64 * a + 8 * c + 2 * qd;
          if (col < d) {
            *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                __floats2bfloat162_rn(o[a][4 * c + 2 * r] / denom,
                                      o[a][4 * c + 2 * r + 1] / denom);
          }
        }
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, looked up through the runtime's entry
// points, so the extension needs no link against libcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess) {
      return (EncodeTiled) nullptr;
    }
    return (EncodeTiled)f;
  }();
  return fn;
}

// (D, rows, heads, batch) bf16 with element strides (row, head, batch);
// boxes of 64 columns x box_rows rows, 128-byte swizzle, zero fill
bool make_map(CUtensorMap* m, const void* ptr, int64_t D, int64_t rows,
              int64_t heads, int64_t batch, int64_t s_row, int64_t s_head,
              int64_t s_batch, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)rows,
                              (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)s_row * 2, (cuuint64_t)s_head * 2,
                                 (cuuint64_t)s_batch * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DMAX>
int launch(const Params& p, cudaStream_t s) {
  constexpr int kBytes = Smem<DMAX>::kBytes;
  // shared memory above 48 KB must be allowed once per kernel
  static const int attr_err = (int)cudaFuncSetAttribute(
      flash_wgmma_kernel<DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kBytes);
  if (attr_err != 0) return attr_err;
  TmaParams tp;
  tp.p = p;
  if (!make_map(&tp.q, p.q, p.D, p.S, p.H, p.B, p.q_ss, p.q_sh, p.q_sb, kBM) ||
      !make_map(&tp.k, p.k, p.D, p.T, p.KV, p.B, p.k_ss, p.k_sh, p.k_sb, kBN) ||
      !make_map(&tp.v, p.v, p.D, p.T, p.KV, p.B, p.v_ss, p.v_sh, p.v_sb, kBN)) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t blocks = (p.S + kBM - 1) / kBM * p.B * p.H;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  flash_wgmma_kernel<DMAX><<<(unsigned int)blocks, kThreads, kBytes, s>>>(tp);
  return (int)cudaGetLastError();
}

int dispatch(const Params& p, cudaStream_t s) {
  if (p.D <= 64) return launch<64>(p, s);
  if (p.D <= 128) return launch<128>(p, s);
  return launch<256>(p, s);
}

}  // namespace tc

}  // namespace

// dtype: 0 -> float32 (flash_simt_kernel: D a multiple of 4, at most 256),
// 1 -> bfloat16 (flash_wgmma_kernel: D a multiple of 16, at most 256; every
// pointer 16-byte aligned and every stride a multiple of 8 elements, as TMA
// requires of a tensor map).  q, k, v and out share the type.  Strides
// are in elements: (batch, head, row) for each tensor; the head dimension is
// contiguous.
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* out, int64_t B,
    int64_t H, int64_t KV, int64_t S, int64_t T, int64_t D,
    const int64_t* strides, int causal, int64_t window, float scale,
    int dtype, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return 0;
  if (T <= 0 || KV <= 0 || H % KV != 0 || D <= 0 || D > 256 ||
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
  if (dtype == 0) {
    if (D % 4 != 0) return (int)cudaErrorInvalidValue;
    return simt::dispatch(p, s);
  }
  if (dtype == 1) {
    // TMA box coordinates are 32-bit
    if (D % 16 != 0 || S > 0x7fffffff || T > 0x7fffffff) {
      return (int)cudaErrorInvalidValue;
    }
    for (int i = 0; i < 12; ++i) {
      if (strides[i] % 8 != 0) return (int)cudaErrorInvalidValue;
    }
    if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16) {
      return (int)cudaErrorInvalidValue;
    }
    return tc::dispatch(p, s);
  }
  return (int)cudaErrorInvalidValue;
}
