// Fused RMSNorm (K5): y = x * (1 / sqrt(mean(x^2) + eps)) * gain per row,
// in float32, written in x's type.
//
// repro_rmsnorm replaces the Pallas kernel src/repro/kernels/rmsnorm.py
// (_rmsnorm_kernel / rmsnorm_2d); the model's every RMSNorm goes through it.
//
// Bound on this card: bytes moved.  Each row is read from device memory
// once and written once (the gain stays in L1/L2), and the arithmetic is
// three operations per element.  Design: one warp per row, four rows a
// block.  The row is read once, as 16-byte vectors (8 bf16 or 4 float32 a
// lane, neighbouring lanes on neighbouring vectors), into registers, with
// the gain beside it: up to VPL vectors a lane, VPL picked by the launch
// from d so the registers held match the row (gemma3's d = 1152 in bf16 is
// 144 vectors, 4.5 a lane, so VPL = 5).  The float32 squares are
// summed in float64 (a shuffle reduction) and the mean rounded once to
// float32, so the result does not depend on the order of summation; the
// normalised row is written from the registers as 16-byte vectors.  A row
// whose start or whose gain is not 16-byte aligned, and the last d % (8 or
// 4) elements, go through a scalar loop in the same kernel; vectors past
// 32 * VPL a lane (d above 4096 in bf16, 2048 in float32) are read again
// for the second pass instead of being kept.  The arithmetic follows the
// reference's order: the mean as a sum divided by d, an IEEE 1/sqrtf
// (rsqrtf is approximate), then (x * inv) * gain, rounded to nearest-even
// when the output is bf16.  The plain version in rmsnorm.py computes the
// same.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
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

// 16-byte vectors of T: element i of a uint4 as a float (bf16 widens
// exactly by a shift), and N floats back into a uint4 (bf16 rounded to
// nearest-even), with no local-memory arrays
template <typename T>
struct Vec;

__device__ __forceinline__ uint32_t word(const uint4& u, int j) {
  return j == 0 ? u.x : (j == 1 ? u.y : (j == 2 ? u.z : u.w));
}

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static float at(const uint4& u, int i) {
    return __uint_as_float(word(u, i));
  }
  template <typename F>
  __device__ __forceinline__ static uint4 make(F f) {
    return make_uint4(__float_as_uint(f(0)), __float_as_uint(f(1)),
                      __float_as_uint(f(2)), __float_as_uint(f(3)));
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static float at(const uint4& u, int i) {
    const uint32_t w = word(u, i >> 1);
    return __uint_as_float((i & 1) ? (w & 0xffff0000u) : (w << 16));
  }
  template <typename F>
  __device__ __forceinline__ static uint4 make(F f) {
    return make_uint4(pack(f(0), f(1)), pack(f(2), f(3)), pack(f(4), f(5)),
                      pack(f(6), f(7)));
  }
  __device__ __forceinline__ static uint32_t pack(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
};

template <typename T>
__device__ __forceinline__ double sum_squares(const uint4& v) {
  double ss = 0.0;
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) {
    const float f = Vec<T>::at(v, i);
    ss += (double)(f * f);  // rounded to float32, as the reference squares
  }
  return ss;
}

template <typename T>
__device__ __forceinline__ uint4 normalise(const uint4& x, const uint4& g,
                                           float inv) {
  return Vec<T>::make([&](int i) {
    return (Vec<T>::at(x, i) * inv) * Vec<T>::at(g, i);
  });
}

// blocks an SM should hold at once: for rows of up to 6 vectors a lane
// (d = 1536 in bf16) registers are capped at 85 so 6 blocks (24 warps)
// fit, enough loads in flight to keep device memory busy
template <int VPL>
constexpr int min_blocks() {
  return VPL <= 6 ? 6 : 1;
}

template <typename T, int VPL>
__global__ void __launch_bounds__(kThreads, min_blocks<VPL>())
    rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ gain,
                   T* __restrict__ out, int64_t n, int64_t d, float eps) {
  constexpr int N = Vec<T>::N;
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n) return;  // uniform across the warp
  const T* xr = x + row * d;
  T* yr = out + row * d;
  const bool aligned =
      (((uintptr_t)xr | (uintptr_t)yr | (uintptr_t)gain) & 15) == 0;
  const int64_t n_vec = aligned ? d / N : 0;
  const uint4* xv = reinterpret_cast<const uint4*>(xr);
  const uint4* gv = reinterpret_cast<const uint4*>(gain);
  uint4* yv = reinterpret_cast<uint4*>(yr);

  // pass 1: the row and the gain into registers, the sum of squares in
  // float64
  uint4 xb[VPL];
  uint4 gb[VPL];
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int64_t v = lane + 32 * i;
    if (v < n_vec) {
      xb[i] = xv[v];
      gb[i] = gv[v];
    }
  }
  double ss = 0.0;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    if (lane + 32 * i < n_vec) ss += sum_squares<T>(xb[i]);
  }
  for (int64_t v = lane + 32 * VPL; v < n_vec; v += 32) {
    ss += sum_squares<T>(xv[v]);
  }
  for (int64_t k = n_vec * N + lane; k < d; k += 32) {
    const float f = to_float(xr[k]);
    ss += (double)(f * f);
  }
  for (int off = 16; off > 0; off >>= 1) {
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  }
  const float var = (float)(ss / (double)d);
  const float inv = 1.0f / sqrtf(var + eps);

  // pass 2: normalise and scale, written as 16-byte vectors
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int64_t v = lane + 32 * i;
    if (v < n_vec) yv[v] = normalise<T>(xb[i], gb[i], inv);
  }
  for (int64_t v = lane + 32 * VPL; v < n_vec; v += 32) {
    yv[v] = normalise<T>(xv[v], gv[v], inv);
  }
  for (int64_t k = n_vec * N + lane; k < d; k += 32) {
    yr[k] = from_float<T>((to_float(xr[k]) * inv) * to_float(gain[k]));
  }
}

template <typename T, int VPL>
void launch_vpl(const T* x, const T* gain, T* out, int64_t n, int64_t d,
                float eps, unsigned int blocks, cudaStream_t s) {
  rmsnorm_kernel<T, VPL><<<blocks, kThreads, 0, s>>>(x, gain, out, n, d, eps);
}

template <typename T>
int launch(const void* x, const void* gain, void* out, int64_t n, int64_t d,
           float eps, cudaStream_t s) {
  const int64_t blocks = (n + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  // vectors a lane, rounded up to an instantiated count, so the registers
  // held match the row (gemma3's d = 1152 in bf16: 5)
  const int64_t per_lane = (d / Vec<T>::N + 31) / 32;
  const T* xp = (const T*)x;
  const T* gp = (const T*)gain;
  T* yp = (T*)out;
  const unsigned int nb = (unsigned int)blocks;
  if (per_lane <= 1) {
    launch_vpl<T, 1>(xp, gp, yp, n, d, eps, nb, s);
  } else if (per_lane <= 2) {
    launch_vpl<T, 2>(xp, gp, yp, n, d, eps, nb, s);
  } else if (per_lane <= 3) {
    launch_vpl<T, 3>(xp, gp, yp, n, d, eps, nb, s);
  } else if (per_lane <= 4) {
    launch_vpl<T, 4>(xp, gp, yp, n, d, eps, nb, s);
  } else if (per_lane <= 5) {
    launch_vpl<T, 5>(xp, gp, yp, n, d, eps, nb, s);
  } else if (per_lane <= 6) {
    launch_vpl<T, 6>(xp, gp, yp, n, d, eps, nb, s);
  } else if (per_lane <= 8) {
    launch_vpl<T, 8>(xp, gp, yp, n, d, eps, nb, s);
  } else if (per_lane <= 12) {
    launch_vpl<T, 12>(xp, gp, yp, n, d, eps, nb, s);
  } else {
    launch_vpl<T, 16>(xp, gp, yp, n, d, eps, nb, s);
  }
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
