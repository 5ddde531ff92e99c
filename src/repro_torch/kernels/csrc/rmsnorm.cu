// Fused RMSNorm (K5): y = x * (1 / sqrt(mean(x^2) + eps)) * gain per row,
// in float32, written in x's type.
//
// repro_rmsnorm replaces the Pallas kernel src/repro/kernels/rmsnorm.py
// (_rmsnorm_kernel / rmsnorm_2d); the model's every RMSNorm goes through it.
//
// Bound on this card: bytes moved.  Each row is read from device memory
// once and written once (the gain stays in L1/L2), and the arithmetic is
// three operations per element.  Design: one warp per row with the row kept
// whole (gemma3's d = 1152 is 2.3 KB in bf16); lanes stride the feature axis
// so a warp touches contiguous bytes, the float32 squares are summed in
// float64 (a shuffle reduction) and the mean rounded once to float32, so the
// result does not depend on the order of summation, and the second pass
// (normalise, scale) re-reads the row from L1.  The arithmetic follows the
// reference's order: the mean as a sum divided by d, an IEEE 1/sqrtf (rsqrtf
// is approximate), then (x * inv) * gain, rounded to nearest-even when the
// output is bf16.  The plain version in rmsnorm.py computes the same.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ gain,
                   T* __restrict__ out, int64_t n, int64_t d, float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n) return;  // uniform across the warp
  const T* xr = x + row * d;
  T* yr = out + row * d;
  double ss = 0.0;
  for (int64_t k = lane; k < d; k += 32) {
    const float v = to_float(xr[k]);
    const float sq = v * v;  // rounded to float32, as the reference squares
    ss += (double)sq;
  }
  for (int off = 16; off > 0; off >>= 1) {
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  }
  const float var = (float)(ss / (double)d);
  const float inv = 1.0f / sqrtf(var + eps);
  for (int64_t k = lane; k < d; k += 32) {
    yr[k] = from_float<T>((to_float(xr[k]) * inv) * to_float(gain[k]));
  }
}

template <typename T>
int launch(const void* x, const void* gain, void* out, int64_t n, int64_t d,
           float eps, cudaStream_t s) {
  const int64_t blocks = (n + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  rmsnorm_kernel<T><<<(unsigned int)blocks, kThreads, 0, s>>>(
      (const T*)x, (const T*)gain, (T*)out, n, d, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 -> float32, 1 -> bfloat16 (x, gain and out share it).
extern "C" int repro_rmsnorm(const void* x, const void* gain, void* out,
                             int64_t n, int64_t d, float eps, int dtype,
                             void* stream) {
  if (n <= 0 || d <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(x, gain, out, n, d, eps, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, gain, out, n, d, eps, s);
  return (int)cudaErrorInvalidValue;
}
