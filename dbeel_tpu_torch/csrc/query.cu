// K8 — the query plane's float64 filter and aggregate kernels for Hopper.
//
// Replaces the jitted twins of dbeel_tpu/ops/query_kernels.py (_kernels):
//   K8a cmp_f64     (vals OP operand) & valid         -> byte mask
//   K8b range_f64   valid & (!use_lo | vals >= lo) & (!use_hi | vals < hi)
//   K8c sum_f64     sum(where(mask, vals, 0))
//   K8d min_max_f64 (min(where(mask, vals, +inf)), max(where(mask, vals, -inf)))
//
// What bounds them: bytes.  A filter pass reads 8 B of value and 1 B of
// validity per row and writes 1 B of mask; a reduction reads 9 B per row.
// At the scan stage's ~1M rows that is ~10 MB, about 3 us at 3.35 TB/s,
// so a launch (a few us) is of the same order: the design is one pass,
// one thread per row in a grid-stride loop with neighbouring threads on
// neighbouring rows (coalesced 8 B and 1 B accesses), and for the
// reductions one fixed-shape second pass instead of atomics.
//
// Semantics, as numpy gives them:
//   * comparisons are IEEE (no fast-math): NaN != x is true, every other
//     comparison with NaN is false, -0.0 == 0.0, +-inf compare normally,
//     subnormals are kept (XLA's CPU backend flushes them to zero);
//   * the sum's order is fixed for a given n (per-thread strided
//     partials, then warp shuffles, then one final block over at most
//     kMaxBlocks partials), so a result is deterministic;
//   * min/max propagate a masked-in NaN (fmin/fmax would drop it) and
//     order -0.0 below +0.0, as XLA's min/max do; an empty mask gives
//     +inf / -inf.
//
// Every entry enqueues on ``stream`` and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1024;  // pass-1 blocks of a reduction
constexpr int64_t kGridCap = 132 * 32;

enum { kEq = 0, kNe, kLt, kLe, kGt, kGe };

template <int OP>
__device__ __forceinline__ bool compare(double v, double x) {
  if (OP == kEq) return v == x;
  if (OP == kNe) return v != x;
  if (OP == kLt) return v < x;
  if (OP == kLe) return v <= x;
  if (OP == kGt) return v > x;
  return v >= x;
}

template <int OP>
__global__ void cmp_kernel(const double* __restrict__ vals,
                           const uint8_t* __restrict__ valid, int64_t n,
                           double operand, uint8_t* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    out[i] = (valid[i] != 0) && compare<OP>(vals[i], operand);
  }
}

__global__ void range_kernel(const double* __restrict__ vals,
                             const uint8_t* __restrict__ valid, int64_t n,
                             double lo, double hi, int use_lo, int use_hi,
                             uint8_t* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const double v = vals[i];
    out[i] = (valid[i] != 0) && (!use_lo || v >= lo) && (!use_hi || v < hi);
  }
}

int grid_for(int64_t n) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  return (int)(blocks < kGridCap ? blocks : kGridCap);
}

// Pass-1 block count of a reduction over n rows: a function of n alone,
// so the summation order (and the result) is fixed for a given n.
int partial_blocks(int64_t n) {
  int64_t blocks = (n + kThreads * 4 - 1) / (kThreads * 4);
  if (blocks < 1) blocks = 1;
  return (int)(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

// ---- sum --------------------------------------------------------------

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// The block's sum, in thread 0.
__device__ double block_sum(double v) {
  __shared__ double part[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? part[lane] : 0.0;
    v = warp_sum(v);
  }
  return v;
}

__global__ void sum_partials(const double* __restrict__ vals,
                             const uint8_t* __restrict__ mask, int64_t n,
                             double* __restrict__ partials) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  double acc = 0.0;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    if (mask[i]) acc += vals[i];
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

__global__ void sum_final(const double* __restrict__ partials, int count,
                          double* __restrict__ out) {
  double v = (int)threadIdx.x < count ? partials[threadIdx.x] : 0.0;
  v = block_sum(v);
  if (threadIdx.x == 0) *out = v;
}

// ---- min / max ----------------------------------------------------------

// NaN is the one value unequal to itself; the sign bit is the top bit.
__device__ __forceinline__ bool is_nan(double a) { return a != a; }
__device__ __forceinline__ bool sign_set(double a) {
  return __double_as_longlong(a) < 0;
}

__device__ __forceinline__ double min_nan(double a, double b) {
  if (is_nan(a)) return a;
  if (is_nan(b)) return b;
  if (a == b) return sign_set(a) ? a : b;  // -0.0 below +0.0
  return a < b ? a : b;
}

__device__ __forceinline__ double max_nan(double a, double b) {
  if (is_nan(a)) return a;
  if (is_nan(b)) return b;
  if (a == b) return sign_set(a) ? b : a;  // +0.0 above -0.0
  return a > b ? a : b;
}

// The block's (min, max), in thread 0.
__device__ void block_min_max(double& mn, double& mx) {
  __shared__ double part_mn[32], part_mx[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    mn = min_nan(mn, __shfl_down_sync(0xffffffffu, mn, o));
    mx = max_nan(mx, __shfl_down_sync(0xffffffffu, mx, o));
  }
  if (lane == 0) {
    part_mn[warp] = mn;
    part_mx[warp] = mx;
  }
  __syncthreads();
  if (warp == 0) {
    const bool live = lane < (int)(blockDim.x >> 5);
    mn = live ? part_mn[lane] : CUDART_INF;
    mx = live ? part_mx[lane] : -CUDART_INF;
    for (int o = 16; o > 0; o >>= 1) {
      mn = min_nan(mn, __shfl_down_sync(0xffffffffu, mn, o));
      mx = max_nan(mx, __shfl_down_sync(0xffffffffu, mx, o));
    }
  }
}

__global__ void min_max_partials(const double* __restrict__ vals,
                                 const uint8_t* __restrict__ mask, int64_t n,
                                 double* __restrict__ partials) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  double mn = CUDART_INF, mx = -CUDART_INF;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    if (mask[i]) {
      const double v = vals[i];
      mn = min_nan(mn, v);
      mx = max_nan(mx, v);
    }
  }
  block_min_max(mn, mx);
  if (threadIdx.x == 0) {
    partials[2 * blockIdx.x] = mn;
    partials[2 * blockIdx.x + 1] = mx;
  }
}

__global__ void min_max_final(const double* __restrict__ partials, int count,
                              double* __restrict__ out) {
  const bool live = (int)threadIdx.x < count;
  double mn = live ? partials[2 * threadIdx.x] : CUDART_INF;
  double mx = live ? partials[2 * threadIdx.x + 1] : -CUDART_INF;
  block_min_max(mn, mx);
  if (threadIdx.x == 0) {
    out[0] = mn;
    out[1] = mx;
  }
}

}  // namespace

extern "C" {

// Pass-1 partial count of a reduction over n rows (the wrapper sizes its
// scratch with it: one double per partial for the sum, two for min/max).
int dbeel_query_partials(int64_t n) { return partial_blocks(n); }

int dbeel_query_cmp_f64(const double* vals, const uint8_t* valid, int64_t n,
                        double operand, int op, uint8_t* out,
                        cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const int grid = grid_for(n);
  switch (op) {
    case kEq:
      cmp_kernel<kEq><<<grid, kThreads, 0, stream>>>(vals, valid, n, operand, out);
      break;
    case kNe:
      cmp_kernel<kNe><<<grid, kThreads, 0, stream>>>(vals, valid, n, operand, out);
      break;
    case kLt:
      cmp_kernel<kLt><<<grid, kThreads, 0, stream>>>(vals, valid, n, operand, out);
      break;
    case kLe:
      cmp_kernel<kLe><<<grid, kThreads, 0, stream>>>(vals, valid, n, operand, out);
      break;
    case kGt:
      cmp_kernel<kGt><<<grid, kThreads, 0, stream>>>(vals, valid, n, operand, out);
      break;
    case kGe:
      cmp_kernel<kGe><<<grid, kThreads, 0, stream>>>(vals, valid, n, operand, out);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int dbeel_query_range_f64(const double* vals, const uint8_t* valid, int64_t n,
                          double lo, double hi, int use_lo, int use_hi,
                          uint8_t* out, cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  range_kernel<<<grid_for(n), kThreads, 0, stream>>>(vals, valid, n, lo, hi,
                                                     use_lo, use_hi, out);
  return (int)cudaGetLastError();
}

int dbeel_query_sum_f64(const double* vals, const uint8_t* mask, int64_t n,
                        double* partials, double* out, cudaStream_t stream) {
  const int blocks = partial_blocks(n);
  sum_partials<<<blocks, kThreads, 0, stream>>>(vals, mask, n, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_final<<<1, kMaxBlocks, 0, stream>>>(partials, blocks, out);
  return (int)cudaGetLastError();
}

int dbeel_query_min_max_f64(const double* vals, const uint8_t* mask,
                            int64_t n, double* partials, double* out,
                            cudaStream_t stream) {
  const int blocks = partial_blocks(n);
  min_max_partials<<<blocks, kThreads, 0, stream>>>(vals, mask, n, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  min_max_final<<<1, kMaxBlocks, 0, stream>>>(partials, blocks, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
