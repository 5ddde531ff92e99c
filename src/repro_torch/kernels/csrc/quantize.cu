// Row-scaled stochastic quantization: ECD-PSGD's compression operator C(.)
// (paper Eq. 7), as a quantize kernel (K3) and a dequantize kernel (K4).
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
