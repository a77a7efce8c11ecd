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
// column ascends over all m rows and bucket b's rows are the contiguous
// run [starts[b], starts[b+1]) of the stack:
//   nvalid    = first row whose key_len is the sentinel
//   starts[0] = 0, starts[n_dev] = nvalid,
//   starts[b] = min(nvalid, #rows with k0 <= splitters[b-1])  (0 < b < n_dev)
// — #(splitters < k0) < b exactly when k0 <= splitters[b-1].  The JAX
// body's bucket / counts / cumsum / col = i - starts[bucket] and its
// scatter with mode="drop" into a sentinel-filled buffer therefore make
// bucket b's slot of the send buffer (capacity * 9 words) a copy of the
// word range local[starts[b] * 9 ...] for its first min(count_b,
// capacity) rows, and the sentinel after them.  overflow = sum_b max(0,
// count_b - capacity), the valid rows JAX drops.
//
// Design.  The grid is (chunks, n_dev): blockIdx.y is the bucket, and a
// block owns 1024 16-byte vectors of its slot, four a thread.  Each block
// finds its run once: warps 0, 1 and 2 search nvalid, starts[b] and
// starts[b+1] at once, each 32 probes a round (csrc/merge_path.cu's
// co-rank search: 4 rounds at m = 131072, where a binary search takes
// 17 dependent loads).  Then every word is a copy or the sentinel by one
// 32-bit comparison with the run's word count; no thread divides a word
// index by 9 or by the capacity, and the only 64-bit arithmetic is the
// slot's and the run's base.  Stores are 16 bytes wide from the slot's
// first 16-byte boundary; the up to 3 words before it and after the last
// vector go one by one.  The source run starts at starts[b] * 9 words,
// any alignment, so a thread reads its vector's four words with 4-byte
// loads, which a warp coalesces into the same 512 bytes its stores
// cover (measured faster than two aligned 16-byte loads shifted by the
// run's offset, which is the same for every vector of a slot: PERF.md
// §6).  A word past the run's end takes the sentinel without a load,
// and four vectors' loads are in flight a thread before their stores.
// Block (0, 0) also searches every bucket's end (its warps in turn) and
// writes the overflow word, so no atomics are needed; the result is
// deterministic.
//
// Bound: bytes.  K9b reads at most the m local rows and writes the send
// buffer once (at the wide cell, m = 131072 and capacity = 65568 with
// n_dev = 4: 4.7 MB in, 9.4 MB out, about 4.2 us at 3.35 TB/s).  What
// holds it above the bound (PERF.md §6 has its time): the searches' 4
// dependent rounds of loads ahead of any copy (a block's copy waits on
// them; the grid of 580 blocks is one wave, so they are paid once), and
// the wave's start and tail.  K9a moves 128 words and is launch-bound.
//
// Interface: plain C, launched on the caller's stream, no allocation,
// returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kSentinel = 0xFFFFFFFFu;
constexpr uint32_t kCols = 9;
constexpr uint32_t kThreads = 256;
constexpr uint32_t kVecs = 4;      // 16-byte vectors a thread
constexpr uint32_t kMaxDev = 192;  // buckets (the wrapper checks)

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

// The first row of [0, m) where `pred` is false; pred holds on a prefix
// of the rows.  The whole warp searches: each lane tests one of 32
// points of the range, and the ballot's count narrows it 32-fold a round
// (csrc/merge_path.cu's co-rank search).  Warp-uniform arguments only.
template <typename Pred>
__device__ uint32_t warp_search(uint32_t m, Pred pred) {
  uint32_t lo = 0, hi = m;
  const uint32_t lane = threadIdx.x & 31;
  while (lo < hi) {
    const uint32_t step = (hi - lo + 31) >> 5;
    const uint32_t x = lo + lane * step;
    const bool p = x < hi && pred(x);
    const uint32_t c = __popc(__ballot_sync(0xFFFFFFFFu, p));
    if (c == 0) {
      hi = lo;
    } else {
      const uint32_t top = lo + c * step;
      lo += (c - 1) * step + 1;
      hi = top < hi ? top : hi;
    }
  }
  return lo;
}

// The first sentinel row (the valid rows are a prefix).
__device__ uint32_t valid_rows(const uint32_t* local, uint32_t m) {
  return warp_search(m, [&](uint32_t r) {
    return __ldg(local + (uint64_t)r * kCols + 4) != kSentinel;
  });
}

// Where bucket b's rows end before the clamp to nvalid: #rows whose k0
// is <= splitters[b] (the k0 column ascends), m for the last bucket.
__device__ uint32_t bucket_end(const uint32_t* local, uint32_t m,
                               const uint32_t* splitters, uint32_t n_dev,
                               uint32_t b) {
  if (b + 1 >= n_dev) return m;
  const uint32_t x = __ldg(splitters + b);
  return warp_search(
      m, [&](uint32_t r) { return __ldg(local + (uint64_t)r * kCols) <= x; });
}

__global__ void __launch_bounds__(kThreads)
    bucket_scatter_kernel(const uint32_t* local, uint32_t m,
                          const uint32_t* splitters, uint32_t n_dev,
                          uint32_t capacity, uint32_t* send,
                          uint32_t* overflow) {
  __shared__ uint32_t found[3];       // nvalid, starts[b], starts[b+1]
  __shared__ uint32_t ends[kMaxDev];  // block (0, 0): every bucket's end
  const uint32_t b = blockIdx.y;
  const uint32_t warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < 3) {
    uint32_t r;
    if (warp == 0) {
      r = valid_rows(local, m);
    } else if (warp == 1) {
      r = b ? bucket_end(local, m, splitters, n_dev, b - 1) : 0;
    } else {
      r = bucket_end(local, m, splitters, n_dev, b);
    }
    if (lane == 0) found[warp] = r;
  }
  __syncthreads();
  const uint32_t nvalid = found[0];
  const uint32_t start = min(found[1], nvalid);
  const uint32_t end = max(start, min(found[2], nvalid));
  const uint32_t words = capacity * kCols;  // < 2^32 (the wrapper checks)
  const uint32_t copy_words = min(end - start, capacity) * kCols;
  uint32_t* dst = send + (uint64_t)b * words;
  const uint32_t* src = local + (uint64_t)start * kCols;

  if (blockIdx.x == 0 && b == 0) {
    for (uint32_t bb = warp; bb < n_dev; bb += kThreads / 32) {
      const uint32_t r = bucket_end(local, m, splitters, n_dev, bb);
      if (lane == 0) ends[bb] = r;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      uint32_t over = 0, s = 0;
      for (uint32_t bb = 0; bb < n_dev; ++bb) {
        const uint32_t e = max(s, min(ends[bb], nvalid));
        if (e - s > capacity) over += e - s - capacity;
        s = e;
      }
      overflow[0] = over;
    }
  }

  // Slot words [head, tail) as 16-byte vectors, the rest one by one.
  const uint32_t head =
      min(words, (uint32_t)((16 - ((uintptr_t)dst & 15)) & 15) >> 2);
  const uint32_t nvec = (words - head) >> 2;
  const uint32_t tail = head + 4 * nvec;
  if (blockIdx.x == 0) {  // threads 0-3 the head, 4-7 the tail
    const uint32_t t = threadIdx.x;
    const uint32_t x = t < head ? t : t >= 4 ? tail + (t - 4) : words;
    if (x < words) dst[x] = x < copy_words ? __ldg(src + x) : kSentinel;
  }
  uint4* dv = reinterpret_cast<uint4*>(dst + head);
  const uint32_t v0 = blockIdx.x * (kVecs * kThreads) + threadIdx.x;
  uint4 val[kVecs];
#pragma unroll
  for (uint32_t u = 0; u < kVecs; ++u) {
    const uint32_t v = v0 + u * kThreads;
    const uint32_t x = head + 4 * v;  // the vector's first slot word
    uint32_t w[4];
#pragma unroll
    for (uint32_t e = 0; e < 4; ++e)
      w[e] = x + e < copy_words ? __ldg(src + x + e) : kSentinel;
    val[u] = make_uint4(w[0], w[1], w[2], w[3]);
  }
#pragma unroll
  for (uint32_t u = 0; u < kVecs; ++u) {
    const uint32_t v = v0 + u * kThreads;
    if (v < nvec) dv[v] = val[u];
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
// (n_dev, capacity, 9) u32 + overflow (1,) u32.  2 <= n_dev <= 192,
// m * 9 and capacity * 9 below 2^32.  Counted as "K9b" by
// parallel/dist_merge.py bucket_scatter_kernel.
int dbeel_dist_bucket_scatter(const uint32_t* local, uint32_t m,
                              const uint32_t* splitters, uint32_t n_dev,
                              uint32_t capacity, uint32_t* send,
                              uint32_t* overflow, void* stream) {
  if (n_dev < 2 || n_dev > kMaxDev) return (int)cudaErrorInvalidValue;
  const uint32_t vecs = capacity * kCols / 4;
  uint32_t chunks = (vecs + kVecs * kThreads - 1) / (kVecs * kThreads);
  if (chunks == 0) chunks = 1;
  bucket_scatter_kernel<<<dim3(chunks, n_dev), kThreads, 0,
                          (cudaStream_t)stream>>>(
      local, m, splitters, n_dev, capacity, send, overflow);
  return (int)cudaGetLastError();
}

}  // extern "C"
