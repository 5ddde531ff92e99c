// L0-distance kernels: the per-row count of differing coordinates behind
// every C_sim and LS_A character of the dataset (paper Eq. 3, §IV.A).
//
// K1 repro_l0_rows replaces the Pallas kernel src/repro/kernels/csim.py
// (_l0_kernel / l0_rows).  K2 repro_l0_shift_sum replaces the scan over
// rolled copies in csim.py (csim_kernel) and the per-shift l0_rows calls
// of metrics.py (_pairwise_l0_means): it reads row (i + j) % b in place for
// each shift j, so no rolled copy of X is ever written.
//
// Bound on this card: bytes read.  K1 reads each of its two (n, d) float32
// inputs once and does one compare per element; K2 reads its (nb, b, d)
// input once from device memory (the r shifted reads of a row hit L2 or L1)
// and does r compares per element, far below the card's compare rate.
// Design: one warp per row, lanes striding the feature axis so a warp reads
// 128 contiguous bytes per step, and a shuffle reduction.  Counts are exact
// integers; K2 sums them across blocks with 64-bit atomics, so the totals
// do not depend on the order in which blocks run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void l0_rows_kernel(const float* __restrict__ x,
                               const float* __restrict__ y,
                               float* __restrict__ out, int64_t n, int64_t d,
                               float tol) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n) return;  // uniform across the warp
  const float* xr = x + row * d;
  const float* yr = y + row * d;
  unsigned int count = 0;
  for (int64_t k = lane; k < d; k += 32) {
    count += fabsf(xr[k] - yr[k]) > tol;
  }
  for (int off = 16; off > 0; off >>= 1) {
    count += __shfl_down_sync(0xffffffffu, count, off);
  }
  if (lane == 0) out[row] = (float)count;
}

__global__ void l0_shift_sum_kernel(const float* __restrict__ x,
                                    unsigned long long* __restrict__ out,
                                    int64_t b, int64_t d, int64_t r,
                                    int64_t blocks_per_batch, float tol) {
  __shared__ unsigned long long partial[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t batch = blockIdx.x / blocks_per_batch;
  const int64_t i =
      (blockIdx.x % blocks_per_batch) * (int64_t)kWarps + warp;
  unsigned long long count = 0;
  if (i < b) {
    const float* base = x + batch * b * d;
    const float* xi = base + i * d;
    for (int64_t j = 1; j <= r; ++j) {
      const float* xp = base + ((i + j) % b) * d;
      for (int64_t k = lane; k < d; k += 32) {
        count += fabsf(xi[k] - xp[k]) > tol;
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    count += __shfl_down_sync(0xffffffffu, count, off);
  }
  if (lane == 0) partial[warp] = count;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long total = 0;
    for (int w = 0; w < kWarps; ++w) total += partial[w];
    if (total) atomicAdd(out + batch, total);
  }
}

}  // namespace

extern "C" int repro_l0_rows(const float* x, const float* y, float* out,
                             int64_t n, int64_t d, float tol, void* stream) {
  if (n <= 0) return 0;
  const int64_t blocks = (n + kWarps - 1) / kWarps;
  l0_rows_kernel<<<(unsigned int)blocks, kThreads, 0,
                   (cudaStream_t)stream>>>(x, y, out, n, d, tol);
  return (int)cudaGetLastError();
}

// out must hold nb zeroed int64 totals; x is (nb, b, d) row-major.
extern "C" int repro_l0_shift_sum(const float* x, int64_t* out, int64_t nb,
                                  int64_t b, int64_t d, int64_t r, float tol,
                                  void* stream) {
  if (nb <= 0 || b <= 0 || r <= 0) return 0;
  const int64_t per_batch = (b + kWarps - 1) / kWarps;
  l0_shift_sum_kernel<<<(unsigned int)(nb * per_batch), kThreads, 0,
                        (cudaStream_t)stream>>>(
      x, (unsigned long long*)out, b, d, r, per_batch, tol);
  return (int)cudaGetLastError();
}
