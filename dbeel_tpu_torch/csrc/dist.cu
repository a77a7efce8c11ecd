// K9a and K9b — the sample sort's own kernels for Hopper (sm_90a).
//
// Replace the middle of the shard_map body of dbeel_tpu/parallel/
// dist_merge.py (_per_device :67, launched by _dist_kernel :117); its two
// local sorts are K5 (csrc/bitonic.cu) and its all_gather / all_to_all are
// device copies between the partitions' tensors (parallel/dist_merge.py):
//   K9a splitters       (:76-86)  sort the gathered n_dev * 32 samples as
//                                 unsigned words, keep every 32nd
//   K9b bucket_scatter  (:88-102) bucket each sorted local row by its first
//                                 key word, count, detect overflow, lay the
//                                 rows out in the (n_dev, capacity, 9) send
//                                 buffer
//
// K9a is one block: at most a few hundred samples, ranked by counting
// (rank = #smaller + #equal-and-earlier, a stable sort without passes),
// then the splitters picked from the ranked copy in shared memory.
//
// K9b's input is the local stack after its sort: rows ascend on
// (k0, ..., k3, key_len, ...), the valid rows (key_len != 0xFFFFFFFF) come
// first and the sentinel rows (all words 0xFFFFFFFF) last, so the k0
// column ascends over all m rows, each bucket is one contiguous run of
// rows and the runs' starts are binary searches:
//   nvalid    = first row whose key_len is the sentinel
//   starts[0] = 0, starts[n_dev] = nvalid,
//   starts[b] = min(nvalid, #rows with k0 <= splitters[b-1])  (0 < b < n_dev)
// — #(splitters < k0) < b exactly when k0 <= splitters[b-1].  The JAX
// body's bucket / counts / cumsum / col = i - starts[bucket] follow, so
// rather than scatter the rows (which needs a fill pass first) the grid
// runs over the send buffer's words and each pulls its source: word
// (b, c, w) is local[starts[b] + c][w] when c < count_b, the sentinel
// otherwise (JAX's scatter with mode="drop" into a sentinel-filled
// buffer).  Every output word is written once, no atomics, the result
// is deterministic.  overflow = sum_b max(0, count_b - capacity), the
// valid rows JAX drops, is written by block 0.
//
// Bound: bytes.  K9b reads at most the m local rows and writes the send
// buffer once (at the wide cell, m = 131072 and capacity = 65568 with
// n_dev = 4: 4.7 MB in, 9.4 MB out, about 4.2 us at 3.35 TB/s); each
// block also does n_dev + 1 binary searches of log2(m) steps, mostly L2
// hits.  K9a moves 128 words and is launch-bound.
//
// Interface: plain C, launched on the caller's stream, no allocation,
// returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kSentinel = 0xFFFFFFFFu;
constexpr int kCols = 9;
constexpr int kThreads = 256;
constexpr uint64_t kGridCap = 132 * 16;

__global__ void splitters_kernel(const uint32_t* samples, uint32_t s,
                                 uint32_t n_dev, uint32_t* splitters) {
  extern __shared__ uint32_t sm[];
  uint32_t* in = sm;
  uint32_t* ranked = sm + s;
  for (uint32_t i = threadIdx.x; i < s; i += blockDim.x) in[i] = samples[i];
  __syncthreads();
  for (uint32_t i = threadIdx.x; i < s; i += blockDim.x) {
    const uint32_t v = in[i];
    uint32_t rank = 0;
    for (uint32_t j = 0; j < s; ++j) {
      const uint32_t u = in[j];
      rank += (u < v) || (u == v && j < i);
    }
    ranked[rank] = v;
  }
  __syncthreads();
  const uint32_t step = s / n_dev;
  for (uint32_t i = threadIdx.x; i + 1 < n_dev; i += blockDim.x)
    splitters[i] = ranked[(i + 1) * step - 1];
}

// #rows whose k0 is <= x (the k0 column ascends).
__device__ uint32_t rows_k0_at_most(const uint32_t* local, uint32_t m,
                                    uint32_t x) {
  uint32_t lo = 0, hi = m;
  while (lo < hi) {
    const uint32_t mid = lo + (hi - lo) / 2;
    if (local[(uint64_t)mid * kCols] <= x)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// The first sentinel row (the valid rows are a prefix).
__device__ uint32_t valid_rows(const uint32_t* local, uint32_t m) {
  uint32_t lo = 0, hi = m;
  while (lo < hi) {
    const uint32_t mid = lo + (hi - lo) / 2;
    if (local[(uint64_t)mid * kCols + 4] == kSentinel)
      hi = mid;
    else
      lo = mid + 1;
  }
  return lo;
}

__global__ void bucket_scatter_kernel(const uint32_t* local, uint32_t m,
                                      const uint32_t* splitters,
                                      uint32_t n_dev, uint32_t capacity,
                                      uint32_t* send, uint32_t* overflow) {
  extern __shared__ uint32_t starts[];  // n_dev + 1
  const uint32_t t = threadIdx.x;
  if (t <= n_dev) {
    const uint32_t nvalid = valid_rows(local, m);
    uint32_t s = nvalid;
    if (t == 0) {
      s = 0;
    } else if (t < n_dev) {
      const uint32_t at_most = rows_k0_at_most(local, m, splitters[t - 1]);
      s = at_most < nvalid ? at_most : nvalid;
    }
    starts[t] = s;
  }
  __syncthreads();
  if (blockIdx.x == 0 && t == 0) {
    uint32_t over = 0;
    for (uint32_t b = 0; b < n_dev; ++b) {
      const uint32_t count = starts[b + 1] - starts[b];
      if (count > capacity) over += count - capacity;
    }
    overflow[0] = over;
  }
  const uint64_t total = (uint64_t)n_dev * capacity * kCols;
  for (uint64_t w = blockIdx.x * (uint64_t)blockDim.x + t; w < total;
       w += (uint64_t)gridDim.x * blockDim.x) {
    const uint64_t row = w / kCols;
    const uint32_t word = (uint32_t)(w % kCols);
    const uint32_t b = (uint32_t)(row / capacity);
    const uint32_t col = (uint32_t)(row % capacity);
    const uint32_t count = starts[b + 1] - starts[b];
    send[w] = col < count
                  ? local[(uint64_t)(starts[b] + col) * kCols + word]
                  : kSentinel;
  }
}

}  // namespace

extern "C" {

// K9a: samples (s,) u32, s = n_dev * 32 -> splitters (n_dev - 1,) u32,
// sorted[31::32][:n_dev-1] of the samples as unsigned words.  s words of
// input and s of ranks live in shared memory (s <= 6144).  Counted as
// "K9a" by parallel/dist_merge.py splitters_kernel.
int dbeel_dist_splitters(const uint32_t* samples, uint32_t s, uint32_t n_dev,
                         uint32_t* splitters, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned threads = s < (uint32_t)kThreads ? s : kThreads;
  splitters_kernel<<<1, threads, 2 * s * sizeof(uint32_t), st>>>(
      samples, s, n_dev, splitters);
  return (int)cudaGetLastError();
}

// K9b: local (m, 9) u32 sorted rows, splitters (n_dev - 1,) u32 -> send
// (n_dev, capacity, 9) u32 + overflow (1,) u32.  n_dev < kThreads.
// Counted as "K9b" by parallel/dist_merge.py bucket_scatter_kernel.
int dbeel_dist_bucket_scatter(const uint32_t* local, uint32_t m,
                              const uint32_t* splitters, uint32_t n_dev,
                              uint32_t capacity, uint32_t* send,
                              uint32_t* overflow, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const uint64_t total = (uint64_t)n_dev * capacity * kCols;
  uint64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kGridCap) blocks = kGridCap;
  if (blocks == 0) blocks = 1;
  bucket_scatter_kernel<<<(unsigned)blocks, kThreads,
                          (n_dev + 1) * sizeof(uint32_t), st>>>(
      local, m, splitters, n_dev, capacity, send, overflow);
  return (int)cudaGetLastError();
}

}  // extern "C"
