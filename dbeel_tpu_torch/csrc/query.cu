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
// so a launch (a few us) is of the same order, and on the host side the
// wrapper's own cost (ops/query_kernels.py) is larger than either.
//
// K8a, K8c and K8d take four rows per thread: the values through two 16 B
// (double2) loads, the validity or mask through one 4 B load, K8a's mask
// through one 4 B store — the widest access each operand allows, with
// neighbouring threads on neighbouring 16 B.  The grid is ceil(n / 1024)
// blocks of 256 threads (977 at 10^6 rows, ~7 per SM), no grid-stride
// loop for the filter.  The vector path needs the values on a 16 B
// boundary and the byte operands on 4 B; a view that starts elsewhere
// (vals[1:]) takes the scalar path (one row per load) with the same
// results.  K8b keeps its first design: one row per thread in a
// grid-stride loop.
//
// K8c and K8d are one launch each.  Each block sums a contiguous chunk of rows whose
// bounds depend on n alone (a multiple of 1024 rows, at most kMaxBlocks
// chunks); the mask is applied with a select (m ? v : 0.0), not a
// branch, so every load is unconditional.  A block writes its partial,
// fences, and takes a ticket with atomicAdd; the block that takes the
// last ticket sums the partials in index order and resets the ticket for
// the next launch.  The ticket lives after the partials in one scratch
// buffer the wrapper zeroes once per (card, stream), so launches on two
// streams never share one.  The summation order (per thread: its rows in
// order; then fixed warp and block trees; then the partials in a fixed
// tree) is a function of n alone, so every call gives the same bits
// whichever block finishes last, and the scalar path adds in the same
// order as the vector path.  K8d is the same launch with (min, max)
// pairs for partials, in a scratch of its own.
//
// Semantics, as numpy gives them:
//   * comparisons are IEEE (no fast-math): NaN != x is true, every other
//     comparison with NaN is false, -0.0 == 0.0, +-inf compare normally,
//     subnormals are kept (XLA's CPU backend flushes them to zero);
//   * a masked-in NaN or +-inf propagates through the sum; an empty mask
//     or n = 0 sums to +0.0 (a sum that starts at +0.0 never becomes
//     -0.0, so adding 0.0 for a masked-out row changes no bits);
//   * min/max propagate a masked-in NaN (fmin/fmax would drop it) and
//     order -0.0 below +0.0, as XLA's min/max do; an empty mask gives
//     +inf / -inf.
//
// Every entry enqueues on ``stream`` and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1024;  // K8c/K8d partials
constexpr int64_t kGridCap = 132 * 32;
// K8a/K8c/K8d: four rows per thread, 1024 rows per block.
constexpr int kRows = 4;
constexpr int64_t kBlockRows = (int64_t)kThreads * kRows;

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

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

// One row: the mask byte (0 or 1).
template <int OP>
__device__ __forceinline__ uint32_t cmp_row(uint32_t valid, double v,
                                            double x) {
  return (uint32_t)((valid & 0xffu) != 0 && compare<OP>(v, x));
}

// K8a's vector path: rows 4t..4t+3 per thread (t the global thread), the
// values as two double2, the validity and the mask as one 32-bit word.
// The last thread with rows finishes a tail of n % 4 rows one by one.
template <int OP>
__global__ void __launch_bounds__(kThreads)
    cmp4_kernel(const double* __restrict__ vals,
                const uint8_t* __restrict__ valid, int64_t n, double operand,
                uint8_t* __restrict__ out) {
  const int64_t row = ((int64_t)blockIdx.x * kThreads + threadIdx.x) * kRows;
  if (row + kRows <= n) {
    const double2* v2 = reinterpret_cast<const double2*>(vals + row);
    const double2 a = __ldg(v2);
    const double2 b = __ldg(v2 + 1);
    const uint32_t m =
        __ldg(reinterpret_cast<const unsigned int*>(valid + row));
    const uint32_t r = cmp_row<OP>(m, a.x, operand) |
                       cmp_row<OP>(m >> 8, a.y, operand) << 8 |
                       cmp_row<OP>(m >> 16, b.x, operand) << 16 |
                       cmp_row<OP>(m >> 24, b.y, operand) << 24;
    *reinterpret_cast<uint32_t*>(out + row) = r;
  } else {
    for (int64_t i = row; i < n; ++i) {
      out[i] = (uint8_t)cmp_row<OP>(valid[i], vals[i], operand);
    }
  }
}

// K8a's scalar path (operands off the vector path's alignment): one row
// per thread in a grid-stride loop.
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

// K8c: one launch.  Block b sums rows [b * chunk, min((b + 1) * chunk, n))
// four at a time, thread t taking units t, t + 256, ... of its block's
// chunk; VEC selects 16 B value loads and 4 B mask loads (both operands
// aligned, chunk a multiple of 1024 rows), else one load per row.  The
// scalar path adds the same four selected values in the same order, so
// both give the same bits.  partials holds kMaxBlocks doubles, then the
// 32-bit ticket (zero between launches).
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    sum_kernel(const double* __restrict__ vals,
               const uint8_t* __restrict__ mask, int64_t n, int64_t chunk,
               double* partials, double* __restrict__ out) {
  const int64_t begin = (int64_t)blockIdx.x * chunk;
  const int64_t end = begin + chunk < n ? begin + chunk : n;
  double acc = 0.0;
  for (int64_t row = begin + (int64_t)threadIdx.x * kRows; row < end;
       row += kBlockRows) {
    double v0, v1, v2, v3;
    uint32_t m;
    if (VEC && row + kRows <= end) {
      const double2* p = reinterpret_cast<const double2*>(vals + row);
      const double2 a = __ldg(p);
      const double2 b = __ldg(p + 1);
      v0 = a.x, v1 = a.y, v2 = b.x, v3 = b.y;
      m = __ldg(reinterpret_cast<const unsigned int*>(mask + row));
    } else {
      const int64_t left = end - row;
      v0 = vals[row];
      v1 = left > 1 ? vals[row + 1] : 0.0;
      v2 = left > 2 ? vals[row + 2] : 0.0;
      v3 = left > 3 ? vals[row + 3] : 0.0;
      m = (uint32_t)mask[row] |
          (left > 1 ? (uint32_t)mask[row + 1] << 8 : 0u) |
          (left > 2 ? (uint32_t)mask[row + 2] << 16 : 0u) |
          (left > 3 ? (uint32_t)mask[row + 3] << 24 : 0u);
    }
    acc += (m & 0xffu) ? v0 : 0.0;
    acc += (m & 0xff00u) ? v1 : 0.0;
    acc += (m & 0xff0000u) ? v2 : 0.0;
    acc += (m & 0xff000000u) ? v3 : 0.0;
  }
  acc = block_sum(acc);

  __shared__ bool last;
  unsigned int* ticket =
      reinterpret_cast<unsigned int*>(partials + kMaxBlocks);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = acc;
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // The last block: every partial is written and fenced.  Each thread
  // loads its (at most four) partials past L1 (__ldcg) at once, adds them
  // in index order, then the fixed block tree.
  constexpr int kPer = kMaxBlocks / kThreads;
  double mine[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = threadIdx.x + k * kThreads;
    mine[k] = i < (int)gridDim.x ? __ldcg(partials + i) : 0.0;
  }
  double v = 0.0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) v += mine[k];
  v = block_sum(v);
  if (threadIdx.x == 0) {
    *out = v;
    *ticket = 0u;
  }
}

// Rows per K8c block: a multiple of 1024, large enough that at most
// kMaxBlocks chunks cover n — a function of n alone.
int64_t sum_chunk(int64_t n) {
  const int64_t per =
      ceil_div(ceil_div(n, kMaxBlocks), kBlockRows) * kBlockRows;
  return per < kBlockRows ? kBlockRows : per;
}

// ---- min / max ----------------------------------------------------------

// K8d's order: a double's bits as an int64 that orders like the value,
// -0.0 just below +0.0 (sign and magnitude to two's complement); the map
// is its own inverse.  A NaN's key lies past the infinities': above
// order_key(+inf) for a NaN with the sign bit clear, below
// order_key(-inf) for one with it set.
__device__ __forceinline__ long long order_key(long long b) {
  return b ^ ((b >> 63) & 0x7fffffffffffffffll);
}

constexpr long long kInfKey = 0x7ff0000000000000ll;  // order_key(+inf)
constexpr long long kNegInfKey =
    (long long)0x800fffffffffffffull;  // order_key(-inf)

// The block's (lo, hi), in thread 0.
__device__ void block_min_max_keys(long long& lo, long long& hi) {
  __shared__ long long part_lo[32], part_hi[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_down_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_down_sync(0xffffffffu, hi, o));
  }
  if (lane == 0) {
    part_lo[warp] = lo;
    part_hi[warp] = hi;
  }
  __syncthreads();
  if (warp == 0) {
    const bool live = lane < (int)(blockDim.x >> 5);
    lo = live ? part_lo[lane] : kInfKey;
    hi = live ? part_hi[lane] : kNegInfKey;
    for (int o = 16; o > 0; o >>= 1) {
      lo = min(lo, __shfl_down_sync(0xffffffffu, lo, o));
      hi = max(hi, __shfl_down_sync(0xffffffffu, hi, o));
    }
  }
}

// Rows per K8d block: four of K8c's chunks (16 rows a thread), still a
// function of n alone and at most kMaxBlocks blocks.
int64_t min_max_chunk(int64_t n) { return 4 * sum_chunk(n); }

// K8d: one launch, K8c's pattern.  Block b reduces rows [b * chunk,
// min((b + 1) * chunk, n)) four at a time (VEC: 16 B value loads and a
// 4 B mask load; else one load per row); the block's (lo, hi) goes to
// partials[2b], [2b + 1]; the block that takes the last ticket reduces
// the partials and resets the ticket.  partials holds 2 * kMaxBlocks
// 64-bit words, then the 32-bit ticket (zero between launches).
//
// Integer work, no branch: a masked-in row enters the min (lo) and the
// max (hi) of order_key, a masked-out row enters as +inf / -inf.  A
// masked-in NaN shows as hi above order_key(+inf) or lo below
// order_key(-inf); then both results are that NaN (hi's when both
// show) — numpy's and XLA's propagation.  Else the results are lo and
// hi mapped back, -0.0 ordered below +0.0.  Integer min and max are
// exact and commutative, so the bits do not depend on which block
// finishes last.
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    min_max_kernel(const double* __restrict__ vals,
                   const uint8_t* __restrict__ mask, int64_t n, int64_t chunk,
                   long long* partials, double* __restrict__ out) {
  const int64_t begin = (int64_t)blockIdx.x * chunk;
  const int64_t end = begin + chunk < n ? begin + chunk : n;
  long long lo = kInfKey, hi = kNegInfKey;
  for (int64_t row = begin + (int64_t)threadIdx.x * kRows; row < end;
       row += kBlockRows) {
    long long v[kRows];
    uint32_t m;
    if (VEC && row + kRows <= end) {
      const longlong2* p = reinterpret_cast<const longlong2*>(vals + row);
      const longlong2 a = __ldg(p);
      const longlong2 b = __ldg(p + 1);
      v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
      m = __ldg(reinterpret_cast<const unsigned int*>(mask + row));
    } else {
      const int64_t left = end - row;
      const long long* bits = reinterpret_cast<const long long*>(vals);
      m = 0;
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        v[k] = k < left ? bits[row + k] : 0;
        m |= k < left ? (uint32_t)mask[row + k] << (8 * k) : 0u;
      }
    }
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const bool in = (m >> (8 * k)) & 0xffu;
      const long long key = order_key(v[k]);
      lo = min(lo, in ? key : kInfKey);
      hi = max(hi, in ? key : kNegInfKey);
    }
  }
  block_min_max_keys(lo, hi);

  __shared__ bool last;
  unsigned int* ticket =
      reinterpret_cast<unsigned int*>(partials + 2 * kMaxBlocks);
  if (threadIdx.x == 0) {
    partials[2 * blockIdx.x] = lo;
    partials[2 * blockIdx.x + 1] = hi;
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // The last block: every partial is written and fenced; each thread
  // folds its (at most four), read past L1, then the block tree.
  constexpr int kPer = kMaxBlocks / kThreads;
  lo = kInfKey, hi = kNegInfKey;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i < (int)gridDim.x) {
      lo = min(lo, __ldcg(partials + 2 * i));
      hi = max(hi, __ldcg(partials + 2 * i + 1));
    }
  }
  block_min_max_keys(lo, hi);
  if (threadIdx.x == 0) {
    const bool nan = hi > kInfKey || lo < kNegInfKey;
    const long long nan_key = hi > kInfKey ? hi : lo;
    out[0] = __longlong_as_double(order_key(nan ? nan_key : lo));
    out[1] = __longlong_as_double(order_key(nan ? nan_key : hi));
    *ticket = 0u;
  }
}

}  // namespace

extern "C" {

// Doubles of K8c's scratch: kMaxBlocks partials, then the ticket.  The
// wrapper allocates it zeroed, once per (card, stream).
int dbeel_query_sum_scratch() { return kMaxBlocks + 1; }

// 8-byte words of K8d's scratch: kMaxBlocks (lo, hi) pairs, then the
// ticket; allocated like K8c's.
int dbeel_query_min_max_scratch() { return 2 * kMaxBlocks + 1; }

int dbeel_query_cmp_f64(const double* vals, const uint8_t* valid, int64_t n,
                        double operand, int op, uint8_t* out,
                        cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const bool vec = (uintptr_t)vals % 16 == 0 && (uintptr_t)valid % 4 == 0 &&
                   (uintptr_t)out % 4 == 0;
  const int64_t blocks = ceil_div(n, kBlockRows);
  if (vec && blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const unsigned grid = vec ? (unsigned)blocks : (unsigned)grid_for(n);
#define DBEEL_CMP(OP)                                                      \
  case OP:                                                                 \
    if (vec)                                                               \
      cmp4_kernel<OP><<<grid, kThreads, 0, stream>>>(vals, valid, n,       \
                                                     operand, out);        \
    else                                                                   \
      cmp_kernel<OP><<<grid, kThreads, 0, stream>>>(vals, valid, n,        \
                                                    operand, out);         \
    break;
  switch (op) {
    DBEEL_CMP(kEq)
    DBEEL_CMP(kNe)
    DBEEL_CMP(kLt)
    DBEEL_CMP(kLe)
    DBEEL_CMP(kGt)
    DBEEL_CMP(kGe)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef DBEEL_CMP
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

// ``scratch``: dbeel_query_sum_scratch() doubles, zeroed before the first
// launch on ``stream`` and left so by every launch.
int dbeel_query_sum_f64(const double* vals, const uint8_t* mask, int64_t n,
                        double* scratch, double* out, cudaStream_t stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  const int64_t chunk = sum_chunk(n);
  const unsigned blocks = n == 0 ? 1u : (unsigned)ceil_div(n, chunk);
  if ((uintptr_t)vals % 16 == 0 && (uintptr_t)mask % 4 == 0) {
    sum_kernel<true><<<blocks, kThreads, 0, stream>>>(vals, mask, n, chunk,
                                                      scratch, out);
  } else {
    sum_kernel<false><<<blocks, kThreads, 0, stream>>>(vals, mask, n, chunk,
                                                       scratch, out);
  }
  return (int)cudaGetLastError();
}

// ``scratch``: dbeel_query_min_max_scratch() 8-byte words, zeroed before
// the first launch on ``stream`` and left so by every launch.
int dbeel_query_min_max_f64(const double* vals, const uint8_t* mask,
                            int64_t n, long long* scratch, double* out,
                            cudaStream_t stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  const int64_t chunk = min_max_chunk(n);
  const unsigned blocks = n == 0 ? 1u : (unsigned)ceil_div(n, chunk);
  if ((uintptr_t)vals % 16 == 0 && (uintptr_t)mask % 4 == 0) {
    min_max_kernel<true><<<blocks, kThreads, 0, stream>>>(vals, mask, n, chunk,
                                                          scratch, out);
  } else {
    min_max_kernel<false><<<blocks, kThreads, 0, stream>>>(vals, mask, n,
                                                           chunk, scratch, out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
