// Row-scaled stochastic quantization: ECD-PSGD's compression operator C(.)
// (paper Eq. 7), as a quantize kernel (K3), a dequantize kernel (K4) and
// one kernel for ECD-PSGD's whole compression tail.
//
// K3 repro_quantize_rows replaces the Pallas kernel
// src/repro/kernels/quantize.py (_quant_kernel / quantize_stochastic_2d);
// K4 repro_dequantize_rows replaces _dequant_kernel / dequantize_2d there.
// Each row of x has its own scale, so ECD-PSGD quantizes every worker's
// vector in one launch; a per-tensor scale is the one-row case.
//
// Bound on this card: bytes moved.  K3 reads x and u (4 + 4 bytes) and
// writes q (1 or 2 bytes) per element; K4 reads q and writes 4 bytes per
// element; the arithmetic is a handful of operations per element.
// Design: one thread per element in a grid-stride loop over the flat
// index, neighbouring threads on neighbouring addresses.  The arithmetic
// matches the reference bit for bit: an IEEE division x / scale (the build
// does not use fast math), then floorf, then the clip.
//
// repro_ecd_compress_rows is K3 and K4 redesigned for the step that calls
// them: ECD-PSGD's tail after the gradient, on rows r = members * m_pad of
// width d,
//
//   x_new = x_half - gamma * grads
//   z     = (1 - t/2) xs + (t/2) x_new
//   cz    = dequantize(quantize(z, u)),  one scale per row
//   y_new = (1 - 2/t) ys + (2/t) cz
//
// i.e. C(.) of quantize_stochastic_2d and dequantize_2d, the scale
// reduction of the Pallas wrapper (quantize.py:48), and the three updates
// around C(.) that the reference's jit fuses with it.  At the main path's
// shapes (8, 32 and 24 rows of d = 28) it moves about 25 KB, 7.5 ns at the
// card's memory rate: a launch's latency sets its time, so the design is
// about launches and dependencies.  One launch per step, coefficients as
// kernel arguments (no device scalar, no host sync), one warp per row for
// d <= 1024 with the row in registers, 16-byte loads when d % 4 == 0 and
// every row is aligned, the row maximum by __shfl_xor_sync; wider rows take
// one block each and two passes.  Every rounding of the plain version
// (kernels/quantize.py ecd_compress_rows_plain) is reproduced: the
// float64-emulated fused multiply-adds of core/numerics.py as __dmul_rn,
// __dadd_rn and __double2float_rn, the float32 products as __fmul_rn, the
// scale and z / scale as __fdiv_rn; the _rn intrinsics keep nvcc from
// contracting a product and a sum into one FMA.  NaN propagates through
// the row maximum and the clip as torch.amax and torch.clamp propagate it
// (fmaxf would drop it).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void quantize_rows_kernel(const float* __restrict__ x,
                                     const float* __restrict__ u,
                                     const float* __restrict__ scale,
                                     T* __restrict__ q, int64_t total,
                                     int64_t d, float qmax) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    float v = floorf(x[i] / scale[i / d] + u[i]);
    v = fminf(fmaxf(v, -qmax - 1.0f), qmax);
    q[i] = (T)(int)v;
  }
}

template <typename T>
__global__ void dequantize_rows_kernel(const T* __restrict__ q,
                                       const float* __restrict__ scale,
                                       float* __restrict__ out, int64_t total,
                                       int64_t d) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    out[i] = (float)q[i] * scale[i / d];
  }
}

unsigned int grid_for(int64_t total) {
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  return (unsigned int)(blocks < 65536 ? blocks : 65536);
}

}  // namespace

// qbytes selects the output type: 1 -> int8, 2 -> int16.
extern "C" int repro_quantize_rows(const float* x, const float* u,
                                   const float* scale, void* q, int64_t rows,
                                   int64_t d, float qmax, int qbytes,
                                   void* stream) {
  const int64_t total = rows * d;
  if (total <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (qbytes == 1) {
    quantize_rows_kernel<int8_t><<<grid_for(total), kThreads, 0, s>>>(
        x, u, scale, (int8_t*)q, total, d, qmax);
  } else if (qbytes == 2) {
    quantize_rows_kernel<int16_t><<<grid_for(total), kThreads, 0, s>>>(
        x, u, scale, (int16_t*)q, total, d, qmax);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int repro_dequantize_rows(const void* q, const float* scale,
                                     float* out, int64_t rows, int64_t d,
                                     int qbytes, void* stream) {
  const int64_t total = rows * d;
  if (total <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (qbytes == 1) {
    dequantize_rows_kernel<int8_t><<<grid_for(total), kThreads, 0, s>>>(
        (const int8_t*)q, scale, out, total, d);
  } else if (qbytes == 2) {
    dequantize_rows_kernel<int16_t><<<grid_for(total), kThreads, 0, s>>>(
        (const int16_t*)q, scale, out, total, d);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

namespace {

// The step's coefficients, rounded on the host as the plain version rounds
// them: the float64 ones enter a float64 product, the float32 ones a
// float32 product.
struct EcdCoef {
  double neg_gamma;  // -gamma
  double z_keep;     // 1 - t/2
  double y_keep;     // 1 - 2/t
  float half;        // t/2
  float two_t;       // 2/t
  float qmax;
};

constexpr int kWarpRowsPerBlock = 4;  // 128-thread blocks, one row a warp
constexpr int kWarpMaxD = 1024;       // wider rows take the two-pass kernel
constexpr int kWideThreads = 512;

// core/numerics.py fma: float32 operands, a float64 product and sum, one
// rounding to float32
__device__ __forceinline__ float fma64(double a, float b, float c) {
  return __double2float_rn(__dadd_rn(__dmul_rn(a, (double)b), (double)c));
}

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float warp_max_nan(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v = max_nan(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  return v;
}

// x_new = fma(-gamma, g, x_half); returns z = fma(1 - t/2, xs, t/2 * x_new)
__device__ __forceinline__ float extrapolate(float g, float xh, float x,
                                             const EcdCoef& c, float* xn) {
  *xn = fma64(c.neg_gamma, g, xh);
  return fma64(c.z_keep, x, __fmul_rn(c.half, *xn));
}

// max(max|z|, 1e-12) / qmax; a NaN maximum stays NaN, as in torch.clamp_min
__device__ __forceinline__ float row_scale(float zmax, float qmax) {
  return __fdiv_rn(zmax < 1e-12f ? 1e-12f : zmax, qmax);
}

// y_new = fma(1 - 2/t, ys, 2/t * q * scale), q = clip(floor(z / scale + u))
__device__ __forceinline__ float compress_update(float z, float u, float y,
                                                 float scale,
                                                 const EcdCoef& c) {
  float v = floorf(__fadd_rn(__fdiv_rn(z, scale), u));
  const float lo = -c.qmax - 1.0f;
  v = v < lo ? lo : (v > c.qmax ? c.qmax : v);  // NaN passes, as torch.clamp
  const float cz = __fmul_rn((float)(int)v, scale);
  return fma64(c.y_keep, y, __fmul_rn(c.two_t, cz));
}

// V consecutive floats of a row: one 16-byte access for V = 4
template <int V>
struct Vec;

template <>
struct Vec<1> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    v[0] = *p;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *p = v[0];
  }
};

template <>
struct Vec<4> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

// One warp per row; lane l holds vectors l, l + 32, ... (N of them, V
// floats each) of z, u and ys in registers between the two halves.
template <int V, int N>
__global__ void __launch_bounds__(kWarpRowsPerBlock * 32)
    ecd_tail_warp_kernel(const float* __restrict__ g,
                         const float* __restrict__ xh,
                         const float* __restrict__ xs,
                         const float* __restrict__ ys,
                         const float* __restrict__ u,
                         float* __restrict__ x_new, float* __restrict__ y_new,
                         int64_t rows, int d, EcdCoef c) {
  const int64_t row =
      (int64_t)blockIdx.x * kWarpRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const int nvec = d / V;
  const int64_t base = row * d;
  float z[N][V], uu[N][V], yy[N][V];
  float zmax = 0.0f;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int j = lane + 32 * k;
    if (j < nvec) {
      const int64_t off = base + (int64_t)j * V;
      float gv[V], hv[V], xv[V], xn[V];
      Vec<V>::load(g + off, gv);
      Vec<V>::load(xh + off, hv);
      Vec<V>::load(xs + off, xv);
      Vec<V>::load(ys + off, yy[k]);
      Vec<V>::load(u + off, uu[k]);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        z[k][e] = extrapolate(gv[e], hv[e], xv[e], c, &xn[e]);
        zmax = max_nan(zmax, fabsf(z[k][e]));
      }
      Vec<V>::store(x_new + off, xn);
    }
  }
  const float scale = row_scale(warp_max_nan(zmax), c.qmax);
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int j = lane + 32 * k;
    if (j < nvec) {
      float yv[V];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        yv[e] = compress_update(z[k][e], uu[k][e], yy[k][e], scale, c);
      }
      Vec<V>::store(y_new + base + (int64_t)j * V, yv);
    }
  }
}

// One block per row of any width, two passes: the first writes x_new and
// parks z in y_new while it reduces the maximum; the second reads z back
// (each thread its own elements) and overwrites it with y_new.
__global__ void __launch_bounds__(kWideThreads)
    ecd_tail_wide_kernel(const float* __restrict__ g,
                         const float* __restrict__ xh,
                         const float* __restrict__ xs,
                         const float* __restrict__ ys,
                         const float* __restrict__ u,
                         float* __restrict__ x_new, float* __restrict__ y_new,
                         int64_t d, EcdCoef c) {
  __shared__ float part[kWideThreads / 32];
  const int64_t base = (int64_t)blockIdx.x * d;
  float zmax = 0.0f;
  for (int64_t i = base + threadIdx.x; i < base + d; i += kWideThreads) {
    float xn;
    const float z = extrapolate(g[i], xh[i], xs[i], c, &xn);
    x_new[i] = xn;
    y_new[i] = z;
    zmax = max_nan(zmax, fabsf(z));
  }
  zmax = warp_max_nan(zmax);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = zmax;
  __syncthreads();
  if (threadIdx.x < 32) {
    zmax = warp_max_nan(threadIdx.x < kWideThreads / 32 ? part[threadIdx.x]
                                                        : 0.0f);
    if (threadIdx.x == 0) part[0] = zmax;
  }
  __syncthreads();
  const float scale = row_scale(part[0], c.qmax);
  for (int64_t i = base + threadIdx.x; i < base + d; i += kWideThreads) {
    y_new[i] = compress_update(y_new[i], u[i], ys[i], scale, c);
  }
}

template <int V, int N>
void launch_warp(const float* g, const float* xh, const float* xs,
                 const float* ys, const float* u, float* x_new, float* y_new,
                 int64_t rows, int64_t d, const EcdCoef& c, cudaStream_t s) {
  const int64_t blocks = (rows + kWarpRowsPerBlock - 1) / kWarpRowsPerBlock;
  ecd_tail_warp_kernel<V, N><<<(unsigned int)blocks, kWarpRowsPerBlock * 32,
                               0, s>>>(g, xh, xs, ys, u, x_new, y_new, rows,
                                       (int)d, c);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// ECD-PSGD's compression tail on (rows, d) float32 rows, all contiguous;
// x_new and y_new are outputs that alias no input.
extern "C" int repro_ecd_compress_rows(
    const float* g, const float* xh, const float* xs, const float* ys,
    const float* u, float* x_new, float* y_new, int64_t rows, int64_t d,
    double neg_gamma, double z_keep, double y_keep, float half, float two_t,
    float qmax, void* stream) {
  if (rows <= 0 || d <= 0) return 0;
  if (rows > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const EcdCoef c{neg_gamma, z_keep, y_keep, half, two_t, qmax};
  cudaStream_t s = (cudaStream_t)stream;
  if (d > kWarpMaxD) {
    ecd_tail_wide_kernel<<<(unsigned int)rows, kWideThreads, 0, s>>>(
        g, xh, xs, ys, u, x_new, y_new, d, c);
    return (int)cudaGetLastError();
  }
  const bool vec = d % 4 == 0 && aligned16(g) && aligned16(xh) &&
                   aligned16(xs) && aligned16(ys) && aligned16(u) &&
                   aligned16(x_new) && aligned16(y_new);
  // vectors per lane, rounded up to a power of two
  const int64_t per_lane = ((vec ? d / 4 : d) + 31) / 32;
  if (vec) {
    if (per_lane <= 1) {
      launch_warp<4, 1>(g, xh, xs, ys, u, x_new, y_new, rows, d, c, s);
    } else if (per_lane <= 2) {
      launch_warp<4, 2>(g, xh, xs, ys, u, x_new, y_new, rows, d, c, s);
    } else if (per_lane <= 4) {
      launch_warp<4, 4>(g, xh, xs, ys, u, x_new, y_new, rows, d, c, s);
    } else {
      launch_warp<4, 8>(g, xh, xs, ys, u, x_new, y_new, rows, d, c, s);
    }
  } else if (per_lane <= 1) {
    launch_warp<1, 1>(g, xh, xs, ys, u, x_new, y_new, rows, d, c, s);
  } else if (per_lane <= 2) {
    launch_warp<1, 2>(g, xh, xs, ys, u, x_new, y_new, rows, d, c, s);
  } else if (per_lane <= 4) {
    launch_warp<1, 4>(g, xh, xs, ys, u, x_new, y_new, rows, d, c, s);
  } else if (per_lane <= 8) {
    launch_warp<1, 8>(g, xh, xs, ys, u, x_new, y_new, rows, d, c, s);
  } else if (per_lane <= 16) {
    launch_warp<1, 16>(g, xh, xs, ys, u, x_new, y_new, rows, d, c, s);
  } else {
    launch_warp<1, 32>(g, xh, xs, ys, u, x_new, y_new, rows, d, c, s);
  }
  return (int)cudaGetLastError();
}
