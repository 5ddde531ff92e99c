// L0-distance kernels: the per-row count of differing coordinates behind
// every C_sim and LS_A character of the dataset (paper Eq. 3, §IV.A).
//
// K1 repro_l0_rows replaces the Pallas kernel src/repro/kernels/csim.py
// (_l0_kernel / l0_rows).  It counts |x_ik - y_ik| > tol per row, or
// |x_ik| > tol when y is null (the row supports: one input read, no zero
// tensor).  Bound on this card: bytes read, each input element once; at
// the main path's shapes (512 to 4096 rows of 28 to 400 floats, 57 KB to
// 6.4 MB) that is 0.02-1.9 us, so the launch and one round trip to device
// memory set the time, and the design keeps every thread's loads in
// flight at once, one round trip deep:
// - 16-byte loads when d % 4 == 0 and both inputs are 16-byte aligned
//   (then every row is); the scalar form otherwise (a view one float off,
//   odd d), and for rows of at most 32 floats, where one 4-byte load a
//   lane already reads the row: at 512 rows of 28 an H100 took 1.46 us
//   that way against 1.50-1.53 us packed four rows to a warp
//   (scripts/time_kernels.py).
// - Narrow rows (32 < d <= 128, 9 to 32 float4s) take L = 16 or 32
//   lanes (the power of two at or above d / 4), two rows or one a warp:
//   each lane makes one load of each input, so 1536 x 48 and 4096 x 64
//   are one load deep.
// - Wider rows take one warp each and issue all of a lane's loads of a
//   512-float pass (4 of each input) before the first compare.
// - Counts are 32-bit integers summed by __reduce_add_sync over the row's
//   lanes (a segment mask for packed rows), written as float.
// - 128-thread blocks, so 512 wide rows are 128 blocks, about one per SM,
//   and 4000 rows are 1000.
// Timed on an H100 against thirteen other layouts of the one-input form
// (blocks of 32 to 256 threads, 1, 2 or 4 rows a warp in flight, 16 or 32
// lanes a row, an L2::256B prefetch hint), none more than 1.5 % faster at
// 512 to 4000 rows of 300 and 400 floats: what is left above the bound
// is the latency of a read from device memory, not the layout.
// Counts are exact, so the output equals l0_rows_plain bit for bit; NaN
// compares false and a negative tol counts every other value, as there.
//
// K2 repro_l0_shift_sum replaces the Pallas scan csim.py:64 (csim_kernel,
// one l0_rows call through _l0_kernel :24 per rolled copy of X) and the
// per-shift l0_rows calls of metrics.py (_pairwise_l0_means).  For X of
// shape (nb, b, d) it writes, per batch k,
//
//   out[k] = sum_{j=1..r} sum_i sum_f [|x_k,i,f - x_k,(i+j)%b,f| > tol]
//
// as an exact int64.  With r = q b + rem, offset s = j % b occurs q + 1
// times for s in 1..rem and q times otherwise, so a block counts each
// distinct offset once and weighs it; no rolled copy is ever written.
//
// What bounds K2 at the main path's shapes, (1, 512, d) with r = 8 and
// (64, 8, d) with r = 7 for d = 400, 28 and 300: launch latency.  0.8 MB
// is 0.25 us of memory time, below one launch, and the compares (r per
// element, no products, so no tensor cores) are far below the card's
// rate.  Bytes begin to bind only at thousands of rows.  The design
// therefore cuts the chain of dependent steps inside one launch:
// - Enough blocks.  A block owns `rows` (T) consecutive rows of one batch,
//   a chunk of offsets and a slice of `width` features; the wrapper
//   (kernels/csim.py shift_sum_plan) picks T = 8 and narrows the slice,
//   not below 32 features, until the grid has about two blocks per SM:
//   256 blocks at both path shapes for d = 400 and 300; rows of d = 28
//   are not sliced, so both shapes launch 64 blocks there, and a batch of
//   8 rows is one block, which writes its total directly.  Indices are
//   32-bit; the shifted row is found at staging time, once per row, never
//   by a modulo in the counting loop.
// - One read of each row, all in flight at once.  The block stages its
//   own T rows and the rows its offsets reach, (i0 + u) % b for u in
//   [0, T) and [s0, s0 + C + T - 1), into shared memory with cp.async:
//   16-byte copies when the pointer, d and the slice allow it, 4-byte
//   copies otherwise (X[3:] with odd d is a legal contiguous input), all
//   issued before one wait.  The staged range is at most 2T + C - 1 rows
//   of `width` floats, within the 47 KB the plan allows; wide rows are cut
//   into slices and a batch so long that its offsets do not fit into
//   chunks of offsets.
// - Counts in registers.  Each thread counts its (row, offset, feature)
//   items in 32-bit registers, four features to a 16-byte shared-memory
//   load on the 16-byte path; a warp shuffle and one block sum follow,
//   and the block's weighted partial is a 64-bit integer.
// - No fill launch.  The blocks of a batch add their partials into a
//   64-bit accumulator and take a ticket; the block that draws the last
//   ticket writes out[k] and returns accumulator and ticket to zero.
//   Where a batch's total stays below 2^40 (b d r < 2^40) partial and
//   ticket travel in one packed atomicAdd, so the chain after the counts
//   is one round trip to L2; a batch of one block writes out[k] directly.
//   The totals are exact whatever order the blocks run in.  The counters
//   live in a scratch buffer that the wrapper zeroes once and keeps per
//   (device, stream), and one more for the graph capture under way:
//   launches on one stream run one after another and each leaves the
//   counters at zero, so back-to-back launches are safe; two launches on
//   different streams use different counters and may overlap safely;
//   launches sharing one counter buffer must not overlap, and the wrapper
//   never hands one buffer to two streams.
//   Whether the packed form applies (pack_bits) and the shared memory a
//   block stages come from the wrapper's plan; the launch checks only that
//   the staged rows fit the block's dynamic shared memory.
//
// repro_empty launches an empty kernel: the practical floor that K1's and
// K2's times are read against.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kL0Threads = 128;
constexpr int kL0Warps = kL0Threads / 32;
constexpr int kL0Unroll = 4;  // float4s of each input a lane holds a pass

template <bool kHasY>
__device__ __forceinline__ unsigned int hits4(const float4 a, const float4 b,
                                              float tol) {
  if (kHasY) {
    return (fabsf(a.x - b.x) > tol) + (fabsf(a.y - b.y) > tol) +
           (fabsf(a.z - b.z) > tol) + (fabsf(a.w - b.w) > tol);
  }
  return (fabsf(a.x) > tol) + (fabsf(a.y) > tol) + (fabsf(a.z) > tol) +
         (fabsf(a.w) > tol);
}

// 8 < d4 = d / 4 <= 32 float4s a row; L = 1 << lanes_log2 >= d4 lanes a
// row (16 or 32), 32 / L rows a warp.  A segment is one row, so it exits
// whole.
template <bool kHasY>
__global__ void __launch_bounds__(kL0Threads)
    l0_rows_narrow_kernel(const float4* __restrict__ x,
                          const float4* __restrict__ y,
                          float* __restrict__ out, int64_t n, int d4,
                          int lanes_log2, float tol) {
  const int lane = threadIdx.x & 31;
  const int seg = lane >> lanes_log2;
  const int k = lane & ((1 << lanes_log2) - 1);
  const int64_t warp = ((int64_t)blockIdx.x * kL0Threads + threadIdx.x) >> 5;
  const int64_t row = (warp << (5 - lanes_log2)) + seg;
  if (row >= n) return;
  unsigned int count = 0;
  if (k < d4) {
    const float4 a = __ldg(x + row * d4 + k);
    const float4 b = kHasY ? __ldg(y + row * d4 + k) : a;
    count = hits4<kHasY>(a, b, tol);
  }
  const unsigned int lanes = 1u << lanes_log2;
  const unsigned int mask =
      lanes == 32 ? 0xffffffffu : ((1u << lanes) - 1u) << (seg * lanes);
  count = __reduce_add_sync(mask, count);
  if (k == 0) out[row] = (float)count;
}

// One warp a row of d4 > 32 float4s, in passes of 32 * kL0Unroll.
template <bool kHasY>
__global__ void __launch_bounds__(kL0Threads)
    l0_rows_wide_kernel(const float4* __restrict__ x,
                        const float4* __restrict__ y, float* __restrict__ out,
                        int64_t n, int d4, float tol) {
  const int lane = threadIdx.x & 31;
  const int64_t row = ((int64_t)blockIdx.x * kL0Threads + threadIdx.x) >> 5;
  if (row >= n) return;  // uniform across the warp
  const float4* xr = x + row * d4;
  const float4* yr = kHasY ? y + row * d4 : xr;
  unsigned int count = 0;
  for (int base = lane; base < d4; base += 32 * kL0Unroll) {
    float4 a[kL0Unroll], b[kL0Unroll];
#pragma unroll
    for (int u = 0; u < kL0Unroll; ++u) {
      const int k = base + 32 * u;
      if (k < d4) {
        a[u] = __ldg(xr + k);
        if (kHasY) b[u] = __ldg(yr + k);
      }
    }
#pragma unroll
    for (int u = 0; u < kL0Unroll; ++u) {
      if (base + 32 * u < d4) {
        count += hits4<kHasY>(a[u], kHasY ? b[u] : a[u], tol);
      }
    }
  }
  count = __reduce_add_sync(0xffffffffu, count);
  if (lane == 0) out[row] = (float)count;
}

// Any d and alignment: one warp a row, lanes striding the features.
template <bool kHasY>
__global__ void __launch_bounds__(kL0Threads)
    l0_rows_scalar_kernel(const float* __restrict__ x,
                          const float* __restrict__ y,
                          float* __restrict__ out, int64_t n, int64_t d,
                          float tol) {
  const int lane = threadIdx.x & 31;
  const int64_t row = ((int64_t)blockIdx.x * kL0Threads + threadIdx.x) >> 5;
  if (row >= n) return;  // uniform across the warp
  const float* xr = x + row * d;
  const float* yr = kHasY ? y + row * d : xr;
  unsigned int count = 0;
#pragma unroll 4
  for (int64_t k = lane; k < d; k += 32) {
    count += fabsf(kHasY ? xr[k] - yr[k] : xr[k]) > tol;
  }
  count = __reduce_add_sync(0xffffffffu, count);
  if (lane == 0) out[row] = (float)count;
}

// The decomposition of one K2 launch, as shift_sum_plan in csim.py made it.
struct ShiftPlan {
  int b, d;
  int rows, width, chunk;       // T, features per slice, offsets per chunk
  int tiles, chunks, slices;    // per batch, slice fastest in blockIdx.x
  int s_lo, n_off;              // offsets s_lo .. s_lo + n_off - 1
  unsigned int q, rem;          // r = q * b + rem
  int pack_bits;                // low bits of a packed counter, 0: unpacked
};

template <int kVec>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const unsigned int s = (unsigned int)__cvta_generic_to_shared(dst);
  if (kVec == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src));
  }
}

// Hits of kVec staged features at x against offsets c_beg .. c_end - 1,
// whose rows lie `width` floats apart from y (16-byte loads when kVec is 4).
template <int kVec>
__device__ __forceinline__ unsigned int hits(const float* x, const float* y,
                                             int width, int c_beg, int c_end,
                                             float tol) {
  unsigned int h = 0;
  if (kVec == 4) {
    const float4 a = *reinterpret_cast<const float4*>(x);
#pragma unroll 4
    for (int c = c_beg; c < c_end; ++c) {
      const float4 v = *reinterpret_cast<const float4*>(y + c * width);
      h += (fabsf(a.x - v.x) > tol) + (fabsf(a.y - v.y) > tol) +
           (fabsf(a.z - v.z) > tol) + (fabsf(a.w - v.w) > tol);
    }
  } else {
    const float a = *x;
#pragma unroll 4
    for (int c = c_beg; c < c_end; ++c) h += fabsf(a - y[c * width]) > tol;
  }
  return h;
}

template <int kVec>
__global__ void __launch_bounds__(kThreads)
    l0_shift_sum_kernel(const float* __restrict__ x,
                        long long* __restrict__ out,
                        unsigned long long* __restrict__ acc,
                        unsigned long long* __restrict__ ticket,
                        const ShiftPlan p, const float tol) {
  extern __shared__ __align__(16) float sm[];
  __shared__ unsigned int warp_lo[kWarps], warp_hi[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int per_batch = p.tiles * p.chunks * p.slices;
  const int batch = blockIdx.x / per_batch;
  int rest = blockIdx.x - batch * per_batch;
  const int slice = rest % p.slices;
  rest /= p.slices;
  const int chunk = rest % p.chunks;
  const int i0 = (rest / p.chunks) * p.rows;
  const int own = min(p.rows, p.b - i0);
  const int f0 = slice * p.width;
  const int fw = min(p.width, p.d - f0);
  const int s0 = p.s_lo + chunk * p.chunk;
  const int cn = min(p.chunk, p.s_lo + p.n_off - s0);
  // staged rows: u in [0, T) at local u, u in [s0, s0 + cn + T - 1) at
  // local u - gap; with s0 <= T the two ranges join and gap is 0
  const int gap = max(s0 - p.rows, 0);
  const int nstage = s0 + cn + p.rows - 1 - gap;

  const float* xb = x + (size_t)batch * p.b * p.d + f0;
  for (int l = warp; l < nstage; l += kWarps) {
    unsigned int row =
        (unsigned int)i0 + (unsigned int)(l < p.rows ? l : l + gap);
    while (row >= (unsigned int)p.b) row -= p.b;  // at most twice
    const float* src = xb + row * p.d;
    float* dst = sm + l * p.width;
    for (int k = lane * kVec; k < fw; k += 32 * kVec) {
      cp_async<kVec>(dst + k, src + k);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // offsets 1..rem weigh q + 1 ("lo"), the others q ("hi"); as chunk
  // indices, lo is [c_lo0, c_lo1)
  const int c_lo0 = min(max(1 - s0, 0), cn);
  const int c_lo1 = min(max((int)p.rem + 1 - s0, c_lo0), cn);
  // an item is kVec consecutive features of one owned row
  const int fv = fw / kVec;
  unsigned int lo = 0, hi = 0;
  for (int it = threadIdx.x; it < own * fv; it += kThreads) {
    const int t = it / fv;
    const int k = (it - t * fv) * kVec;
    const float* xs = sm + t * p.width + k;
    const float* y = sm + (t + s0 - gap) * p.width + k;
    lo += hits<kVec>(xs, y, p.width, c_lo0, c_lo1, tol);
    if (p.q) {
      hi += hits<kVec>(xs, y, p.width, 0, c_lo0, tol) +
            hits<kVec>(xs, y, p.width, c_lo1, cn, tol);
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    lo += __shfl_xor_sync(0xffffffffu, lo, off);
    hi += __shfl_xor_sync(0xffffffffu, hi, off);
  }
  if (lane == 0) {
    warp_lo[warp] = lo;
    warp_hi[warp] = hi;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  unsigned long long sum_lo = 0, sum_hi = 0;
  for (int w = 0; w < kWarps; ++w) {
    sum_lo += warp_lo[w];
    sum_hi += warp_hi[w];
  }
  const unsigned long long part =
      (unsigned long long)p.q * sum_hi + (p.q + 1ull) * sum_lo;
  if (per_batch == 1) {
    out[batch] = (long long)part;
    return;
  }
  if (p.pack_bits) {
    // one atomic carries partial and ticket; the block that draws the last
    // ticket holds the total in the returned word plus its own partial
    const unsigned long long old =
        atomicAdd(acc + batch, (1ull << p.pack_bits) | part);
    if ((old >> p.pack_bits) == (unsigned long long)per_batch - 1) {
      out[batch] = (long long)((old + part) & ((1ull << p.pack_bits) - 1));
      acc[batch] = 0;
    }
    return;
  }
  if (part) atomicAdd(acc + batch, part);
  __threadfence();
  if (atomicAdd(ticket + batch, 1ull) == (unsigned long long)per_batch - 1) {
    __threadfence();
    out[batch] = (long long)atomicExch(acc + batch, 0ull);
    ticket[batch] = 0;
  }
}

__global__ void empty_kernel() {}

template <bool kHasY>
cudaError_t launch_l0_rows(const float* x, const float* y, float* out,
                           int64_t n, int64_t d, float tol, cudaStream_t s) {
  const bool vec = d % 4 == 0 && ((uintptr_t)x & 15) == 0 &&
                   (!kHasY || ((uintptr_t)y & 15) == 0);
  const int64_t d4 = d / 4;
  if (vec && d4 > 8 && d4 <= 32) {
    int lanes_log2 = 0;
    while ((1 << lanes_log2) < d4) ++lanes_log2;
    const int64_t rows_per_block = (int64_t)kL0Warps << (5 - lanes_log2);
    const int64_t blocks = (n + rows_per_block - 1) / rows_per_block;
    if (blocks > INT32_MAX) return cudaErrorInvalidValue;
    l0_rows_narrow_kernel<kHasY><<<(unsigned int)blocks, kL0Threads, 0, s>>>(
        (const float4*)x, (const float4*)y, out, n, (int)d4, lanes_log2, tol);
    return cudaGetLastError();
  }
  const int64_t blocks = (n + kL0Warps - 1) / kL0Warps;
  if (blocks > INT32_MAX || d4 > INT32_MAX) return cudaErrorInvalidValue;
  if (vec && d4 > 32) {
    l0_rows_wide_kernel<kHasY><<<(unsigned int)blocks, kL0Threads, 0, s>>>(
        (const float4*)x, (const float4*)y, out, n, (int)d4, tol);
  } else {
    l0_rows_scalar_kernel<kHasY><<<(unsigned int)blocks, kL0Threads, 0, s>>>(
        x, y, out, n, d, tol);
  }
  return cudaGetLastError();
}

}  // namespace

// y may be null: the count is then against zero.
extern "C" int repro_l0_rows(const float* x, const float* y, float* out,
                             int64_t n, int64_t d, float tol, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(y ? launch_l0_rows<true>(x, y, out, n, d, tol, s)
                 : launch_l0_rows<false>(x, y, out, n, d, tol, s));
}

// x is (nb, b, d) row-major, cut into `blocks` blocks by the wrapper's
// plan (kernels/csim.py shift_sum_plan, which also bounds b * d, r and the
// grid to 31 bits); each block stages stage_rows rows of `width` floats.
// scratch holds 2 * cap zeroed words: the accumulators, then the tickets
// (cap >= nb); with pack_bits > 0 an accumulator holds its ticket count in
// the bits above pack_bits and the tickets are not used.
extern "C" int repro_l0_shift_sum(const float* x, int64_t* out,
                                  unsigned long long* scratch, int64_t cap,
                                  int64_t b, int64_t d, int64_t rows,
                                  int64_t width, int64_t chunk, int64_t tiles,
                                  int64_t chunks, int64_t slices, int64_t s_lo,
                                  int64_t n_off, int64_t q, int64_t rem,
                                  int64_t stage_rows, int64_t blocks,
                                  int pack_bits, float tol, void* stream) {
  if (blocks <= 0) return 0;
  const ShiftPlan p = {(int)b,      (int)d,      (int)rows,
                       (int)width,  (int)chunk,  (int)tiles,
                       (int)chunks, (int)slices, (int)s_lo,
                       (int)n_off,  (unsigned int)q, (unsigned int)rem,
                       pack_bits};
  const bool vec = ((uintptr_t)x & 15) == 0 && d % 4 == 0 && width % 4 == 0;
  const void* kernel = vec ? (const void*)l0_shift_sum_kernel<4>
                           : (const void*)l0_shift_sum_kernel<1>;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)stage_rows * width * sizeof(float);
  if (smem > (size_t)attr.maxDynamicSharedSizeBytes) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  long long* o = (long long*)out;
  if (vec) {
    l0_shift_sum_kernel<4><<<(unsigned int)blocks, kThreads, smem, s>>>(
        x, o, scratch, scratch + cap, p, tol);
  } else {
    l0_shift_sum_kernel<1><<<(unsigned int)blocks, kThreads, smem, s>>>(
        x, o, scratch, scratch + cap, p, tol);
  }
  return (int)cudaGetLastError();
}

// The id of the graph capture under way on the stream, 0 when none is.
extern "C" int repro_capture_id(void* stream, unsigned long long* id) {
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  *id = 0;
  cudaError_t err =
      cudaStreamGetCaptureInfo((cudaStream_t)stream, &status, id);
  if (status != cudaStreamCaptureStatusActive) *id = 0;
  return (int)err;
}

extern "C" int repro_empty(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
