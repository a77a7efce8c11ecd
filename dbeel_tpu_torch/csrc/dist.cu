// K9b — the sample sort's bucket scatter for Hopper (sm_90a), with the
// splitter pick (K9a in PERF.md) folded into its prologue.
//
// Replaces the middle of the shard_map body of dbeel_tpu/parallel/
// dist_merge.py (_per_device :67, launched by _dist_kernel :117); its two
// local sorts are K5 (csrc/bitonic.cu) and its all_gather / all_to_all are
// device copies between the partitions' tensors (parallel/dist_merge.py):
//   splitters (:76-86)   sort the gathered n_dev * 32 samples as unsigned
//                        words, keep every 32nd (K9a)
//   bucket_scatter       bucket each sorted local row by its first key
//   (:88-102)            word, count, detect overflow, lay the rows out in
//                        the (n_dev, capacity, 9) send buffer (K9b)
//
// The splitter pick has no launch of its own.  It moves n_dev * 32 words
// (128 at n_dev = 4), and a launch of its own was the host's 25-35 us for
// 2.6 us of card time.  The samples lie on each partition's card after
// the all_gather, and a block of the scatter needs at most two splitters,
// splitters[b-1] and splitters[b] (block (0, 0) all of them, for the
// overflow).  So every block stages the s = n_dev * 32 samples in shared
// memory and orders them there, as unsigned words, with the warps that
// do not search the valid rows; splitter j is the ordered samples' word
// (j+1) * 32 - 1.  Splitters are values, so any correct order gives the
// reference's bits; stability does not matter.  The order is the bitonic
// network over the samples padded with 0xFFFFFFFF to a power of two S:
//   S <= 256 (n_dev <= 8): in one warp's registers, S/32 words a lane,
//     strides of a lane's words or more by shuffles: no barrier, and at
//     the mesh's n_dev = 4 (S = 128) 28 stages of ~4 compares a lane.
//     Every block of the grid orders the samples (580 at the wide cell,
//     ~4.4 an SM), so the pick is paid in instructions an SM: ranking
//     the 128 samples by counting (s^2 compares a block, about 7x these
//     instructions) measured 1.7 us slower a call (PERF.md §6);
//   S > 256: in shared memory by warps 1-7, a barrier a stage: at
//     n_dev = 192 (s = 6144, S = 8192, 32 KiB) 91 stages of ~19
//     compares a thread, where counting would take 37.7M compares a
//     block, ~168K a thread.
// Block (0, 0) writes the n_dev - 1 splitters to their own output, as it
// writes the overflow word, so the pick stays checkable bit for bit.
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
// finds its run once: warp 0 searches nvalid while warps 1-7 order the
// samples (a named barrier among them), then warps 1 and 2 search
// starts[b] and starts[b+1] against the splitters in shared memory, each
// search 32 probes a round (csrc/merge_path.cu's co-rank search: 4 rounds
// at m = 131072, where a binary search takes 17 dependent loads).  Then
// every word is a copy or the sentinel by one 32-bit comparison with the
// run's word count; no thread divides a word
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
// them; the grid of 580 blocks is one wave, so they are paid once; the
// splitter pick runs beside the first and before the other two), and the
// wave's start and tail.
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

constexpr uint32_t kSamples = 32;    // samples a partition
constexpr uint32_t kWarpMax = 256;   // samples one warp sorts in registers
constexpr uint32_t kPickThreads = kThreads - 32;  // warps 1-7

inline __host__ __device__ uint32_t pow2_at_least(uint32_t v) {
  uint32_t p = 1;
  while (p < v) p <<= 1;
  return p;
}

// Barrier of warps 1-7 (warp 0 searches meanwhile).
__device__ __forceinline__ void pick_barrier() {
  asm volatile("bar.sync 1, %0;" ::"r"(kPickThreads) : "memory");
}

// The bitonic network over 32 * E words (the s samples, then
// 0xFFFFFFFF), held E a lane (word e = lane * E + k) by one warp, sorted
// ascending into sm[0..32E).  A stride of E or more pairs lanes (a
// shuffle), a smaller one registers of a lane.
template <uint32_t E>
__device__ void warp_sort(const uint32_t* samples, uint32_t s,
                          uint32_t* sm) {
  constexpr uint32_t n = 32 * E;
  const uint32_t lane = threadIdx.x & 31;
  uint32_t r[E];
#pragma unroll
  for (uint32_t k = 0; k < E; ++k) {
    const uint32_t e = lane * E + k;
    r[k] = e < s ? __ldg(samples + e) : kSentinel;
  }
#pragma unroll
  for (uint32_t size = 2; size <= n; size <<= 1) {
#pragma unroll
    for (uint32_t j = size >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (uint32_t k = 0; k < E; ++k) {
        const bool asc = ((lane * E + k) & size) == 0;
        if (j >= E) {  // this lane holds the pair's upper word if (lane & j/E)
          const uint32_t o = __shfl_xor_sync(0xFFFFFFFFu, r[k], j / E);
          r[k] = ((lane & (j / E)) != 0) != asc ? min(r[k], o) : max(r[k], o);
        } else if ((k & j) == 0) {
          const uint32_t a = r[k], c = r[k + j];
          r[k] = asc ? min(a, c) : max(a, c);
          r[k + j] = asc ? max(a, c) : min(a, c);
        }
      }
    }
  }
#pragma unroll
  for (uint32_t k = 0; k < E; ++k) sm[lane * E + k] = r[k];
}

// The s gathered samples, ordered as unsigned words, into sm[0..pow2(s))
// by warps 1-7 (warp 0 searches meanwhile): the bitonic network over the
// samples padded with 0xFFFFFFFF to a power of two, in one warp's
// registers (warp 1) for s <= kWarpMax, else in shared memory by all
// seven, a barrier a stage.
__device__ void order_samples(const uint32_t* samples, uint32_t s,
                              uint32_t* sm) {
  const uint32_t n = pow2_at_least(s);
  if (n <= kWarpMax) {
    if (threadIdx.x >> 5 == 1) {
      if (n <= 64) {
        warp_sort<2>(samples, s, sm);
      } else if (n == 128) {
        warp_sort<4>(samples, s, sm);
      } else {
        warp_sort<8>(samples, s, sm);
      }
    }
    pick_barrier();
    return;
  }
  const uint32_t t = threadIdx.x - 32;
  for (uint32_t i = t; i < n; i += kPickThreads)
    sm[i] = i < s ? __ldg(samples + i) : kSentinel;
  pick_barrier();
  for (uint32_t k = 2; k <= n; k <<= 1) {
    for (uint32_t j = k >> 1; j > 0; j >>= 1) {
      for (uint32_t q = t; q < n / 2; q += kPickThreads) {
        const uint32_t lo = ((q & ~(j - 1)) << 1) | (q & (j - 1));
        const uint32_t a = sm[lo], c = sm[lo + j];
        if ((a > c) == ((lo & k) == 0)) {
          sm[lo] = c;
          sm[lo + j] = a;
        }
      }
      pick_barrier();
    }
  }
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
// `ordered`: the ordered samples in shared memory; splitters[b] is word
// (b+1) * 32 - 1 of them.
__device__ uint32_t bucket_end(const uint32_t* local, uint32_t m,
                               const uint32_t* ordered, uint32_t n_dev,
                               uint32_t b) {
  if (b + 1 >= n_dev) return m;
  const uint32_t x = ordered[(b + 1) * kSamples - 1];
  return warp_search(
      m, [&](uint32_t r) { return __ldg(local + (uint64_t)r * kCols) <= x; });
}

__global__ void __launch_bounds__(kThreads)
    bucket_scatter_kernel(const uint32_t* local, uint32_t m,
                          const uint32_t* samples, uint32_t n_dev,
                          uint32_t capacity, uint32_t* send,
                          uint32_t* overflow, uint32_t* splitters) {
  extern __shared__ uint32_t sm[];    // the ordered samples
  __shared__ uint32_t found[3];       // nvalid, starts[b], starts[b+1]
  __shared__ uint32_t ends[kMaxDev];  // block (0, 0): every bucket's end
  const uint32_t b = blockIdx.y;
  const uint32_t warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t* ordered = sm;
  if (warp == 0) {
    const uint32_t r = valid_rows(local, m);
    if (lane == 0) found[0] = r;
  } else {
    order_samples(samples, n_dev * kSamples, sm);
    if (warp < 3) {
      const uint32_t r =
          warp == 1 ? (b ? bucket_end(local, m, ordered, n_dev, b - 1) : 0)
                    : bucket_end(local, m, ordered, n_dev, b);
      if (lane == 0) found[warp] = r;
    }
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
    for (uint32_t j = threadIdx.x; j + 1 < n_dev; j += kThreads)
      splitters[j] = ordered[(j + 1) * kSamples - 1];
    for (uint32_t bb = warp; bb < n_dev; bb += kThreads / 32) {
      const uint32_t r = bucket_end(local, m, ordered, n_dev, bb);
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

// K9b: local (m, 9) u32 sorted rows, samples (n_dev * 32,) u32 (the
// gathered samples of every partition) -> send (n_dev, capacity, 9) u32
// + overflow (1,) u32 + splitters (n_dev - 1,) u32, sorted[31::32][:n_dev
// - 1] of the samples as unsigned words.  2 <= n_dev <= 192, m * 9 and
// capacity * 9 below 2^32.  Counted as "K9b" by parallel/dist_merge.py
// bucket_scatter_kernel.
int dbeel_dist_bucket_scatter(const uint32_t* local, uint32_t m,
                              const uint32_t* samples, uint32_t n_dev,
                              uint32_t capacity, uint32_t* send,
                              uint32_t* overflow, uint32_t* splitters,
                              void* stream) {
  if (n_dev < 2 || n_dev > kMaxDev) return (int)cudaErrorInvalidValue;
  const size_t smem = pow2_at_least(n_dev * kSamples) * sizeof(uint32_t);
  const uint32_t vecs = capacity * kCols / 4;
  uint32_t chunks = (vecs + kVecs * kThreads - 1) / (kVecs * kThreads);
  if (chunks == 0) chunks = 1;
  bucket_scatter_kernel<<<dim3(chunks, n_dev), kThreads, smem,
                          (cudaStream_t)stream>>>(
      local, m, samples, n_dev, capacity, send, overflow, splitters);
  return (int)cudaGetLastError();
}

}  // extern "C"
