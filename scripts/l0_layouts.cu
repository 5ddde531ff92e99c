// Layouts of K1's one-input form (the row-support count of
// src/repro_torch/kernels/csrc/l0.cu), for scripts/time_l0_layouts.py.
// One template, k1_wide<threads a block, rows a warp in flight, lanes a
// row, L2 prefetch hint>, for rows of d = 4 * d4 <= 512 floats with
// 16-byte aligned rows: every lane loads all its float4s of all its rows
// before the first compare, then each row's count is summed by
// __reduce_add_sync over its lanes.  Instance 0 is the port's layout.
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ float4 ld4(const float4* p, bool hint) {
  if (hint) {
    float4 v;
    asm volatile("ld.global.nc.L2::256B.v4.f32 {%0,%1,%2,%3}, [%4];"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p));
    return v;
  }
  return __ldg(p);
}

__device__ __forceinline__ unsigned hits4(float4 a, float tol) {
  return (fabsf(a.x) > tol) + (fabsf(a.y) > tol) + (fabsf(a.z) > tol) +
         (fabsf(a.w) > tol);
}

// LPR lanes a row (32 or 16), RPW rows a warp in flight
template <int TPB, int RPW, int LPR, bool HINT>
__global__ void __launch_bounds__(TPB)
    k1_wide(const float4* __restrict__ x, float* __restrict__ out, int64_t n,
            int d4, float tol) {
  constexpr int U = (128 + LPR - 1) / LPR;  // loads a lane a row (d4 <= 128)
  constexpr int G = 32 / LPR;               // rows side by side in a warp
  const int lane = threadIdx.x & 31;
  const int sub = lane / LPR, k0 = lane % LPR;
  const int64_t warp = ((int64_t)blockIdx.x * TPB + threadIdx.x) >> 5;
  const int64_t row0 = warp * (RPW * G) + sub;
  float4 a[RPW][U];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int64_t row = row0 + r * G;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = k0 + LPR * u;
      if (row < n && k < d4) a[r][u] = ld4(x + row * d4 + k, HINT);
    }
  }
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int64_t row = row0 + r * G;
    unsigned c = 0;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = k0 + LPR * u;
      if (row < n && k < d4) c += hits4(a[r][u], tol);
    }
    const unsigned mask = LPR == 32 ? 0xffffffffu : (0xffffu << (16 * sub));
    c = __reduce_add_sync(mask, c);
    if (k0 == 0 && row < n) out[row] = (float)c;
  }
}

// (id, threads a block, rows a warp, lanes a row, hint)
#define VARIANTS(X)                                                          \
  X(0, 128, 1, 32, false) X(1, 256, 1, 32, false) X(2, 128, 2, 32, false)    \
  X(3, 256, 2, 32, false) X(4, 128, 1, 32, true) X(5, 64, 1, 32, false)      \
  X(6, 128, 4, 32, false) X(7, 128, 1, 16, false) X(8, 64, 1, 16, false)     \
  X(9, 256, 1, 16, false) X(10, 128, 2, 16, false) X(11, 64, 2, 32, false)   \
  X(12, 32, 1, 32, false) X(13, 32, 1, 16, false)

// Instance v on x (n, d): out[i] = #{k : |x_ik| > tol}; -1 for no such v.
extern "C" int k1var(int v, const float* x, float* out, int64_t n, int64_t d,
                     float tol, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int d4 = (int)(d / 4);
#define CASE(ID, TPB, RPW, LPR, HINT)                                      \
  if (v == ID) {                                                           \
    const int64_t rows_per_block = (TPB / 32) * RPW * (32 / LPR);          \
    const unsigned blocks =                                                \
        (unsigned)((n + rows_per_block - 1) / rows_per_block);             \
    k1_wide<TPB, RPW, LPR, HINT><<<blocks, TPB, 0, s>>>((const float4*)x,  \
                                                        out, n, d4, tol);  \
    return (int)cudaGetLastError();                                        \
  }
  VARIANTS(CASE)
  return -1;
}
