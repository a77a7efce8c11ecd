// Merge-path merge of sorted runs — K1, K2, K3 and K6 of dbeel_tpu_torch
// (PERF.md) for Hopper (sm_90a).
//
// Replaces the jax.jit compare-exchange networks of dbeel_tpu/ops/bitonic.py
//   K1 merge_runs_prefix32_packed_batch_kernel  (bitonic.py:235, body :202)
//   K2 merge_runs_prefix64_packed_batch_kernel  (bitonic.py:251, body :218)
//   K3 merge_runs_prefix_kernel / _prefix_kernel_from_runs (:153, :379)
//   K6 merge_runs_prefix_batch_kernel (:284; K3's body _prefix_merge_body
//      :136 vmapped over J coalesced compaction jobs)
// which csrc/bitonic.cu ran stage for stage (one global pass per large
// stride, 19-32 launches a call).  Here each level of the pairwise merge
// is one launch and one pass: K = 8 runs take 3, K6's K = 4 takes 2.
//
// Why the order may differ from the network's and the bits may not.
// Every row is (key words..., idx) and every word is compared (W ==
// NCMP): K1's (v, idx), K2's, K3's and K6's (k0, k1, idx).  A valid row's idx
// = (run << logP) | pos is unique; a padding row (pos >= count) is
// SENTINEL in every word.  So two rows tie on every compared word only
// if both are padding, and then they are bit-identical.  On sorted runs
// the network outputs the sorted sequence of the rows, which is unique
// under that condition, so any correct merge gives the same bits (a
// valid K1 value of 0xFFFFFFFF ties with the padding on its key and
// sorts before it on idx, in the network and here alike).  K4, K5 and
// K7 (9 words, 8 compared, full 8-word ties between rows that differ
// in the carried word) have no such freedom and keep the network's
// order (csrc/bitonic.cu).
//
// Precondition (the caller's; the network needed only the padding):
// each run sorted on its compared words, padding rows SENTINEL in every
// key word.  SSTable runs are sorted by key and the 8-byte big-endian
// prefix is monotone in the key, so the staging of every caller meets
// it (ops/bitonic.py stage_prefixes, server/coalescer.py pack_jobs).  Unsorted
// input gives an unspecified order but never an access out of bounds.
// K2/K3's operand is 8-byte aligned (a row's key is one 8-byte load;
// the wrapper checks), K1's 4-byte (an int32 tensor always is).
//
// Design.  A level merges each pair (A, B) of neighbouring sequences of
// L rows into 2L (K = 1: one run, B empty, the epilogue alone).  A block
// owns a tile of 4096 output rows of one pair (256 threads, 52 KB of
// shared memory for K2/K3, 34 KB for K1).  Warps 0 and 1 find the tile's two
// cuts on the merge path (co-rank: how many of the first d outputs come
// from A) by a 32-way search in global memory, four rounds at L = 2^18.
// The block copies the tile's A and B rows into shared memory with
// cp.async as two columns, the key (K1's u32; K2/K3's k0, k1 as they lie
// in memory: one u64, compared k0 first) and idx; one slot of skew per 128 bytes of a
// column keeps the staging free of bank conflicts.  Each thread finds
// its own cut inside the tile by binary search and merges 16 rows
// sequentially, A first on ties, into registers; the idx go back to
// shared memory and out in coalesced stores.
//
// Between levels a row is its idx alone: idx = run * P + pos is the
// row's place in its job's operand, so a later level fetches the key
// from the operand by idx (a padding row's key is SENTINEL).  The runs
// advance in order, so those reads stay local, and K3's operand (16 MB)
// stays in the 50 MB L2 across its levels.  Fusions: the first level
// builds idx from (run, pos, counts) as it loads, so no staging pass;
// an intermediate level writes idx into one of two work halves
// (ping-pong); the last level writes only the epilogue — K1 and K2 the
// run ids, packed pack_bits to a word in shared memory before the store, K3
// the idx of the first out_rows rows, with no block launched past them.
// The batch axis J is more blocks: a block's job is blockIdx.x /
// tiles_per_job, every row and output offset adds the job's base, and
// kTop stops each job at its own out_rows (K6; K3 is J = 1).  Nothing
// else depends on J: out_rows of 0 launches nothing, K = 1 and K = 2
// are one level (the epilogue; no work half), runs below the tile shrink
// it to one pair, and a job whose counts are all 0 merges SENTINEL rows,
// which tie on every word and come out as SENTINEL idx.
//
// Bound: bytes.  The operand is read once and the epilogue written once
// (K2 at (4, 8, 131072, 2): 32 MiB + 2 MiB, 10.6 us at 3.35 TB/s; K1 at
// (4, 8, 131072): 16 MiB + 2 MiB, 5.6 us; K6 at (8, 4, 131072, 2) with
// 327680 rows out a job: 32 MiB + 10 MiB, 13.1 us; K6's and K3's bound
// follows out_rows).  Each
// intermediate level adds a write and a read of 4 bytes a row and a
// fetch of its 4- or 8-byte key; the comparisons are a few integer ops per
// row and level.  What holds it above the bound (PERF.md): each level
// is one wave of blocks in lock step, search, load, merge and store in
// turn, and the level-by-level passes.
//
// Interface: plain C, launched on the caller's stream, no allocation
// (the wrapper passes the work halves), returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kSentinel = 0xFFFFFFFFu;
constexpr uint32_t kTile = 4096;      // output rows per block
constexpr uint32_t kItems = 16;       // output rows per merging thread
constexpr uint32_t kMinThreads = 64;  // warps 0 and 1 search one cut each

enum Mode { kRows = 0, kTop = 1, kPacked = 2 };

// A row's W-1 key words as one integer: W = 2 (K1) one u32; W = 3 the words
// (k0, k1) as they lie in memory, a little-endian u64 that compares k0
// first once its halves swap (a swap is its own inverse).
template <int W>
struct KeyOf;
template <>
struct KeyOf<2> {
  using T = uint32_t;
  __device__ static uint64_t order(uint64_t k) { return k; }
};
template <>
struct KeyOf<3> {
  using T = unsigned long long;
  __device__ static uint64_t order(uint64_t k) { return (k << 32) | (k >> 32); }
};

// A shared column's slot for row x: one slot of skew per 128 bytes.
template <typename T>
__device__ __forceinline__ uint32_t pad(uint32_t x) {
  return x + x / (128 / sizeof(T));
}

template <typename T>
__host__ __device__ constexpr uint32_t col_slots(uint32_t tile) {
  return tile + tile / (128 / sizeof(T));
}

// Dynamic shared memory of a block of `tile` rows: the key column, then
// the idx column.
template <int W>
__host__ __device__ constexpr size_t smem_bytes(uint32_t tile) {
  using Key = typename KeyOf<W>::T;
  return col_slots<Key>(tile) * sizeof(Key) + col_slots<uint32_t>(tile) * 4;
}

struct Level {
  const void* keys;        // the operand, (J, K, P, W-1) words, as keys
  const uint32_t* idx;     // later levels: a work half, the idx column
  const uint32_t* counts;  // (J*K) valid rows per run
  uint32_t* dst_idx;       // kRows: the other work half
  uint32_t* out;           // kTop: (J, out_rows); kPacked: (J, words_per_job)
  uint64_t la, lb;         // rows of each pair's A and B sequence
  uint64_t job_rows;       // K*P
  uint64_t words_per_job;  // kPacked
  uint32_t tile;           // output rows per block: pow2, divides la + lb
  uint32_t tiles_per_job;  // blocks per job
  uint32_t log_p, log_k;
  uint32_t out_rows;       // kTop
  uint32_t pack_bits;      // kPacked
};

// The index column (bitonic.py :140-146, :206-211): (run << logP) | pos
// for a valid row, SENTINEL past the run's count; global row r of the
// operand is ((j * K) + run) * P + pos.
__device__ __forceinline__ uint32_t first_idx(const Level& a, uint64_t r) {
  const uint32_t pos = (uint32_t)(r & ((1ull << a.log_p) - 1));
  const uint64_t jr = r >> a.log_p;
  const uint32_t run = (uint32_t)(jr & ((1ull << a.log_k) - 1));
  return pos < a.counts[jr] ? ((run << a.log_p) | pos) : kSentinel;
}

// (key, idx) a <= b, keys already in compare order.
__device__ __forceinline__ bool row_le(uint64_t ka, uint32_t ia, uint64_t kb,
                                       uint32_t ib) {
  return ka < kb || (ka == kb && ia <= ib);
}

// A later level's rows are idx alone: the key of a valid row is the
// operand's row base + idx of its job (idx = run * P + pos); a padding
// row's is SENTINEL in every word (the precondition).
template <int W>
__device__ __forceinline__ uint64_t key_of(const Level& a, uint64_t base,
                                          uint32_t idx) {
  using Key = typename KeyOf<W>::T;
  const Key k = idx == kSentinel ? static_cast<Key>(~Key(0))
                                 : static_cast<const Key*>(a.keys)[base + idx];
  return KeyOf<W>::order(k);
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(src), "n"(BYTES)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Co-rank of output d of the pair (A at row a0, B at row b0): the number
// of A rows among the merged pair's first d, A first on ties.  The whole
// warp searches: each lane tests one of 32 points of the range, and the
// ballot's count narrows it 32-fold a round.  P(i) = A[i] <= B[d-1-i] is
// true then false along the range; the co-rank is its first false point.
template <int W, bool FIRST>
__device__ uint64_t corank(const Level& a, uint64_t base, uint64_t a0,
                           uint64_t b0, uint64_t d) {
  uint64_t lo = d > a.lb ? d - a.lb : 0;
  uint64_t hi = d < a.la ? d : a.la;
  const uint64_t lane = threadIdx.x & 31;
  while (lo < hi) {
    const uint64_t step = (hi - lo + 31) >> 5;
    const uint64_t m = lo + lane * step;
    bool p = false;
    if (m < hi) {
      const uint64_t ra = a0 + m, rb = b0 + d - 1 - m;
      if (FIRST) {  // the operand's rows; idx only where the keys tie
        using Key = typename KeyOf<W>::T;
        const Key* keys = static_cast<const Key*>(a.keys);
        const uint64_t ka = KeyOf<W>::order(keys[ra]);
        const uint64_t kb = KeyOf<W>::order(keys[rb]);
        p = ka != kb ? ka < kb : first_idx(a, ra) <= first_idx(a, rb);
      } else {
        const uint32_t ia = a.idx[ra], ib = a.idx[rb];
        p = row_le(key_of<W>(a, base, ia), ia, key_of<W>(a, base, ib), ib);
      }
    }
    const uint64_t c = __popc(__ballot_sync(0xFFFFFFFFu, p));
    if (c == 0) {
      hi = lo;
    } else {
      const uint64_t top = lo + c * step;
      lo += (c - 1) * step + 1;
      hi = top < hi ? top : hi;
    }
  }
  return lo;
}

template <int W, int MODE, bool FIRST>
__global__ void __launch_bounds__(kTile / kItems)
    merge_level_kernel(const Level a) {
  using Key = typename KeyOf<W>::T;
  extern __shared__ __align__(16) unsigned char smem[];
  Key* skey = reinterpret_cast<Key*>(smem);
  const uint32_t tile = a.tile;
  uint32_t* sidx =
      reinterpret_cast<uint32_t*>(smem + col_slots<Key>(tile) * sizeof(Key));
  __shared__ uint64_t cut[2];
  const uint64_t job = blockIdx.x / a.tiles_per_job;
  const uint64_t t = blockIdx.x % a.tiles_per_job;
  const uint64_t seg_len = a.la + a.lb;
  const uint64_t o = job * a.job_rows + t * tile;  // first output row
  const uint64_t a0 = o / seg_len * seg_len;
  const uint64_t b0 = a0 + a.la;
  const uint64_t d0 = o - a0;
  const uint64_t base = job * a.job_rows;  // the job's first operand row

  const uint32_t warp = threadIdx.x >> 5;
  if (warp < 2) {
    const uint64_t c =
        corank<W, FIRST>(a, base, a0, b0, d0 + (warp ? tile : 0));
    if ((threadIdx.x & 31) == 0) cut[warp] = c;
  }
  __syncthreads();
  // Clamped so that unsorted input stays in bounds.
  const uint64_t i0 = cut[0];
  uint64_t i1 = cut[1] < i0 ? i0 : cut[1];
  if (i1 > i0 + tile) i1 = i0 + tile;
  const uint32_t na = (uint32_t)(i1 - i0);
  const uint32_t nb = tile - na;
  const uint64_t j0 = d0 - i0;

  // The tile's rows: A's [i0, i1) at slots [0, na), B's from j0 after.
  // On the first level A and B are one run each of the operand: keys
  // straight from it, idx from the run's count.  Later levels load idx,
  // then each thread fetches the keys of its own slots by idx.
  const Key* keys = static_cast<const Key*>(a.keys);
  if (FIRST) {
    const uint32_t count_a = a.counts[a0 >> a.log_p];
    const uint32_t count_b = a.lb ? a.counts[b0 >> a.log_p] : 0;
    const uint32_t run_a =
        (uint32_t)((a0 >> a.log_p) & ((1ull << a.log_k) - 1));
    for (uint32_t x = threadIdx.x; x < tile; x += blockDim.x) {
      const bool in_a = x < na;
      const uint64_t pos = in_a ? i0 + x : j0 + (x - na);
      cp_async<sizeof(Key)>(&skey[pad<Key>(x)], keys + (in_a ? a0 : b0) + pos);
      sidx[pad<uint32_t>(x)] = pos < (in_a ? count_a : count_b)
                                   ? ((run_a + !in_a) << a.log_p) | (uint32_t)pos
                                   : kSentinel;
    }
  } else {
    for (uint32_t x = threadIdx.x; x < tile; x += blockDim.x) {
      const uint64_t r = x < na ? a0 + i0 + x : b0 + j0 + (x - na);
      cp_async<4>(&sidx[pad<uint32_t>(x)], a.idx + r);
    }
    cp_async_wait_all();  // this thread's own slots have landed
    for (uint32_t x = threadIdx.x; x < tile; x += blockDim.x) {
      const uint32_t idx = sidx[pad<uint32_t>(x)];
      if (idx == kSentinel) {
        skey[pad<Key>(x)] = static_cast<Key>(~Key(0));
      } else {
        cp_async<sizeof(Key)>(&skey[pad<Key>(x)], keys + base + idx);
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();

  const uint32_t items = tile < kItems ? tile : kItems;
  const bool worker = threadIdx.x < tile / items;
  const uint32_t diag = threadIdx.x * items;
  uint32_t ridx[kItems];
  if (worker) {
    uint32_t lo = diag > nb ? diag - nb : 0;
    uint32_t hi = diag < na ? diag : na;
    while (lo < hi) {
      const uint32_t mid = (lo + hi) >> 1;
      const uint32_t y = na + diag - 1 - mid;
      const uint64_t ka = KeyOf<W>::order(skey[pad<Key>(mid)]);
      const uint64_t kb = KeyOf<W>::order(skey[pad<Key>(y)]);
      const bool le = ka != kb ? ka < kb
                               : sidx[pad<uint32_t>(mid)] <=
                                     sidx[pad<uint32_t>(y)];
      if (le) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    uint32_t i = lo, j = diag - lo;
    uint64_t ka = ~0ull, kb = ~0ull;
    uint32_t ia = kSentinel, ib = kSentinel;
    if (i < na) {
      ka = KeyOf<W>::order(skey[pad<Key>(i)]);
      ia = sidx[pad<uint32_t>(i)];
    }
    if (j < nb) {
      kb = KeyOf<W>::order(skey[pad<Key>(na + j)]);
      ib = sidx[pad<uint32_t>(na + j)];
    }
#pragma unroll
    for (uint32_t e = 0; e < kItems; ++e) {
      if (e < items) {
        const bool take_a = j >= nb || (i < na && row_le(ka, ia, kb, ib));
        ridx[e] = take_a ? ia : ib;
        if (take_a) {
          if (++i < na) {
            ka = KeyOf<W>::order(skey[pad<Key>(i)]);
            ia = sidx[pad<uint32_t>(i)];
          }
        } else if (++j < nb) {
          kb = KeyOf<W>::order(skey[pad<Key>(na + j)]);
          ib = sidx[pad<uint32_t>(na + j)];
        }
      }
    }
  }
  __syncthreads();
  // Stage the merged rows' idx in tile order.
  if (worker) {
#pragma unroll
    for (uint32_t e = 0; e < kItems; ++e) {
      if (e < items) sidx[pad<uint32_t>(diag + e)] = ridx[e];
    }
  }
  __syncthreads();

  if (MODE == kRows) {
    for (uint32_t x = threadIdx.x; x < tile; x += blockDim.x)
      a.dst_idx[o + x] = sidx[pad<uint32_t>(x)];
  } else if (MODE == kTop) {
    const uint64_t row0 = t * tile;  // within the job
    for (uint32_t x = threadIdx.x; x < tile; x += blockDim.x) {
      if (row0 + x < a.out_rows)
        a.out[job * a.out_rows + row0 + x] = sidx[pad<uint32_t>(x)];
    }
  } else {
    // _pack_rids (bitonic.py :181): per = 32/pack_bits run ids a word,
    // low bits first.  The tile holds whole words, except when the job
    // is shorter than a word: then its one word pads with SENTINEL's
    // run-id bits.
    const uint32_t per = 32 / a.pack_bits;
    const uint32_t mask = (1u << a.pack_bits) - 1;
    const uint32_t words = tile >= per ? tile / per : 1;
    const uint64_t w0 = t * tile / per;
    for (uint32_t w = threadIdx.x; w < words; w += blockDim.x) {
      uint32_t word = 0;
      for (uint32_t e = 0; e < per; ++e) {
        const uint32_t x = w * per + e;
        const uint32_t idx = x < tile ? sidx[pad<uint32_t>(x)] : kSentinel;
        word |= ((idx >> a.log_p) & mask) << (e * a.pack_bits);
      }
      a.out[job * a.words_per_job + w0 + w] = word;
    }
  }
}

inline uint32_t log2_exact(uint64_t v) {
  uint32_t l = 0;
  while ((1ull << l) < v) ++l;
  return l;
}

// Above 48 KiB a block's dynamic shared memory needs the attribute, set
// at each launch: it belongs to the current card.
template <int W, int MODE, bool FIRST>
void launch(unsigned blocks, unsigned threads, const Level& a,
            cudaStream_t st) {
  const size_t bytes = smem_bytes<W>(a.tile);
  if (bytes > 48 * 1024)
    cudaFuncSetAttribute(merge_level_kernel<W, MODE, FIRST>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)bytes);
  merge_level_kernel<W, MODE, FIRST><<<blocks, threads, bytes, st>>>(a);
}

template <int W, int MODE>
void launch_mode(bool first, unsigned blocks, unsigned threads,
                 const Level& a, cudaStream_t st) {
  if (first) {
    launch<W, MODE, true>(blocks, threads, a, st);
  } else {
    launch<W, MODE, false>(blocks, threads, a, st);
  }
}

// log2(K) levels (one for K = 1) over J jobs of K runs of P rows, W-1
// key words a row.  work: min(2, levels - 1) halves of J*K*P idx words.
template <int W>
int merge_runs(const uint32_t* operand, const uint32_t* counts, uint32_t j,
               uint32_t k, uint32_t p, int mode, uint32_t out_rows,
               uint32_t pack_bits, uint32_t* work, uint32_t* out,
               cudaStream_t st) {
  const uint64_t n = (uint64_t)j * k * p;
  if (n == 0 || (mode == kTop && out_rows == 0)) return (int)cudaGetLastError();
  const uint32_t log_k = log2_exact(k);
  const uint32_t levels = log_k ? log_k : 1;
  Level a{};
  a.keys = operand;
  a.counts = counts;
  a.out = out;
  a.job_rows = (uint64_t)k * p;
  a.log_p = log2_exact(p);
  a.log_k = log_k;
  a.out_rows = out_rows;
  a.pack_bits = pack_bits;
  if (mode == kPacked) {
    const uint64_t per = 32 / pack_bits;
    a.words_per_job = (a.job_rows + per - 1) / per;
  }
  for (uint32_t lvl = 0; lvl < levels; ++lvl) {
    const bool first = lvl == 0;
    const bool last = lvl + 1 == levels;
    a.la = (uint64_t)p << lvl;
    a.lb = k == 1 ? 0 : a.la;
    const uint64_t seg_len = a.la + a.lb;
    a.tile = (uint32_t)(seg_len < kTile ? seg_len : kTile);
    a.idx = first ? nullptr : work + (uint64_t)((lvl - 1) & 1) * n;
    a.dst_idx = last ? nullptr : work + (uint64_t)(lvl & 1) * n;
    uint64_t tiles = a.job_rows / a.tile;
    if (last && mode == kTop) tiles = (out_rows + a.tile - 1) / a.tile;
    a.tiles_per_job = (uint32_t)tiles;
    const uint32_t items = a.tile < kItems ? a.tile : kItems;
    const uint32_t threads =
        a.tile / items < kMinThreads ? kMinThreads : a.tile / items;
    const unsigned blocks = (unsigned)(j * tiles);
    const int m = last ? mode : kRows;
    if (m == kRows) {
      launch_mode<W, kRows>(first, blocks, threads, a, st);
    } else if (m == kTop) {
      launch_mode<W, kTop>(first, blocks, threads, a, st);
    } else {
      launch_mode<W, kPacked>(first, blocks, threads, a, st);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K1: vals (J,K,P) u32, counts (J,K) u32 -> out
// (J, ceil(K*P/(32/pack_bits))) u32, the merged rows' run ids packed
// pack_bits to a word; work as for K2.  Counted as "K1" by
// ops/bitonic.py merge_runs_prefix32_packed_batch_kernel.
int dbeel_merge_path_prefix32_packed(const uint32_t* vals,
                                     const uint32_t* counts, uint32_t j,
                                     uint32_t k, uint32_t p,
                                     uint32_t pack_bits, uint32_t* work,
                                     uint32_t* out, void* stream) {
  return merge_runs<2>(vals, counts, j, k, p, kPacked, 0, pack_bits, work,
                       out, (cudaStream_t)stream);
}

// K2: prefixes (J,K,P,2) u32, counts (J,K) u32 -> out
// (J, ceil(K*P/(32/pack_bits))) u32, the merged rows' run ids packed
// pack_bits to a word; work holds min(2, log2(K) - 1) halves of
// J*K*P u32 (none for K <= 2).
int dbeel_merge_path_prefix64_packed(const uint32_t* prefixes,
                                     const uint32_t* counts, uint32_t j,
                                     uint32_t k, uint32_t p,
                                     uint32_t pack_bits, uint32_t* work,
                                     uint32_t* out, void* stream) {
  return merge_runs<3>(prefixes, counts, j, k, p, kPacked, 0, pack_bits,
                       work, out, (cudaStream_t)stream);
}

// K3 and K6: prefixes (J,K,P,2) u32, counts (J,K) u32 -> out
// (J, out_rows) u32, per job the packed (run << logP) | pos of its
// first out_rows merged rows; work as for K2.  Counted as "K3" (J = 1)
// by ops/bitonic.py merge_runs_prefix_kernel and as "K6" by
// merge_runs_prefix_batch_kernel.
int dbeel_merge_path_prefix_top(const uint32_t* prefixes,
                                const uint32_t* counts, uint32_t j,
                                uint32_t k, uint32_t p, uint32_t out_rows,
                                uint32_t* work, uint32_t* out,
                                void* stream) {
  return merge_runs<3>(prefixes, counts, j, k, p, kTop, out_rows, 0, work,
                       out, (cudaStream_t)stream);
}

}  // extern "C"
