// Bitonic merge network over K sorted runs — the compaction merge and
// flush sort kernels of dbeel_tpu_torch (K4, K5 and K7 of PERF.md), for
// Hopper (sm_90a).  K1, K2, K3 and K6 are merge-path merges
// (csrc/merge_path.cu).
//
// Replaces the jax.jit compare-exchange networks of dbeel_tpu/ops/bitonic.py:
//   K4 merge_runs_perm_kernel                    (bitonic.py:104, :81)
//   K5 merge_runs_kernel / sort_stack_kernel     (bitonic.py:95, :114)
//   K7 _sort_kernel + _same_key_mask    (dbeel_tpu/ops/merge.py:35, :42)
//
// Data: a flat array of N = K*P rows of 9 u32 words, compared
// lexicographically on the first 8.  The network is the JAX one exactly,
// not only its sorted result: per level l (runs of P_l = P << l rows),
// each odd run is reversed (JAX's concat(a, b[::-1]), _merge_level :70)
// and half-cleaner stages with strides P_l, P_l/2, ..., 1 swap a pair iff
// lex_gt(lo, hi) is strictly true (_bitonic_to_sorted :53).  Following
// the network bit for bit keeps the output equal even where rows tie on
// every compared word (K4 with long keys sharing a 16-byte prefix, a
// length, a ts and a source; K7's rows tied on all 8 key columns and
// apart in the carried ninth).  The reversal is fused into the first
// stage of each level: one thread owns the two pairs (t, h-1-t) a
// reversal would exchange, so no pass is spent on it.  K5's flush sort
// is the P = 1 case (every row its own run): a one-row run reverses to
// itself, so its first level's flip is a plain stage.
//
// K4, K5 and K7 share one schedule, k5_merge_rows ("One schedule for K4,
// K5 and K7" below), and differ only at its ends.  K5 reads rows and
// writes the sorted rows; K4 writes only their word 8; K7 is the P = 1
// network on nine separate operand columns (lax.sort of 9 u32 operands on
// 8 keys): its first launch reads the columns and its last writes the
// sorted rows back as columns, with _same_key_mask's flags, which have
// no sentinel check.
//
// Bound: bytes.  Each operand row is read once and each output word
// written once; the network does N/2 compare-exchanges per stage, a few
// integer ops each, far under the card's integer rate.  What holds the
// schedule above that bound is its passes (two a level past the tile,
// each reading and writing every row) and the shared-memory stages
// inside them; PERF.md keeps the times.
//
// Interface: plain C, launched on the caller's stream, no allocation
// (the wrapper passes the work buffer), returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kSentinel = 0xFFFFFFFFu;
constexpr int kThreads = 256;
constexpr uint32_t kTile = 1024;  // rows of 9 words in shared memory: 36 KiB

template <int W, typename I>
__device__ __forceinline__ void load_row(const uint32_t* base, I i,
                                         uint32_t (&r)[W]) {
#pragma unroll
  for (int c = 0; c < W; ++c) r[c] = base[i * W + c];
}

template <int W, typename I>
__device__ __forceinline__ void store_row(uint32_t* base, I i,
                                          const uint32_t (&r)[W]) {
#pragma unroll
  for (int c = 0; c < W; ++c) base[i * W + c] = r[c];
}

// a > b lexicographically over the first NCMP words (bitonic.py _lex_gt),
// without a branch.
template <int W, int NCMP>
__device__ __forceinline__ bool lex_gt(const uint32_t (&a)[W],
                                       const uint32_t (&b)[W]) {
  bool gt = false;
#pragma unroll
  for (int c = NCMP - 1; c >= 0; --c)
    gt = (a[c] > b[c]) | ((a[c] == b[c]) & gt);
  return gt;
}

// Compare-exchange of rows i < j: the smaller lands at i; equal rows stay.
// With `turn` row j is read and written first (smem_stage); the result
// is the same.
template <int W, int NCMP, typename I>
__device__ __forceinline__ void cmpx(uint32_t* rows, I i, I j,
                                     bool turn = false) {
  const I first = turn ? j : i, second = turn ? i : j;
  uint32_t x[W], y[W];
  load_row<W>(rows, first, x);
  load_row<W>(rows, second, y);
  if (turn ? lex_gt<W, NCMP>(y, x) : lex_gt<W, NCMP>(x, y)) {
    store_row<W>(rows, first, y);
    store_row<W>(rows, second, x);
  }
}

// First stage of a level, reversal fused: segment [a; b] of 2h rows
// starting at `base`; the reversed b is rb[k] = rows[base + 2h - 1 - k].
// Quad t (t < h/2) owns the pairs k = t and k = h-1-t: it reads the four
// rows a[t], a[h-1-t], b[t], b[h-1-t] and writes the stage's results
// to positions base+k (lo) and base+h+k (hi) for both k.
template <int W, int NCMP, typename I>
__device__ __forceinline__ void flip_quad(uint32_t* rows, I base, I h, I t) {
  uint32_t a0[W], a1[W], b0[W], b1[W];
  load_row<W>(rows, base + t, a0);
  load_row<W>(rows, base + h - 1 - t, a1);
  load_row<W>(rows, base + h + t, b0);
  load_row<W>(rows, base + 2 * h - 1 - t, b1);
  // pair k = t: (a[t], rb[t] = b[h-1-t] = b1); pair k = h-1-t:
  // (a[h-1-t] = a1, rb[h-1-t] = b[t] = b0).
  const bool s0 = lex_gt<W, NCMP>(a0, b1), s1 = lex_gt<W, NCMP>(a1, b0);
  // Word by word: a select of whole arrays would put them in local memory.
#pragma unroll
  for (int c = 0; c < W; ++c) {
    rows[(base + t) * W + c] = s0 ? b1[c] : a0[c];
    rows[(base + h + t) * W + c] = s0 ? a0[c] : b1[c];
    rows[(base + h - 1 - t) * W + c] = s1 ? b0[c] : a1[c];
    rows[(base + 2 * h - 1 - t) * W + c] = s1 ? a1[c] : b0[c];
  }
}

template <int W, int NCMP>
__global__ void flip_stage_kernel(uint32_t* rows, uint64_t n, uint64_t h) {
  const uint64_t q = blockIdx.x * (uint64_t)blockDim.x + threadIdx.x;
  if (q >= n / 4) return;
  const uint64_t quads = h / 2;  // per 2h-row segment
  const uint64_t seg = q / quads;
  flip_quad<W, NCMP>(rows, seg * 2 * h, h, q % quads);
}

template <int W, int NCMP>
__global__ void stage_kernel(uint32_t* rows, uint64_t n, uint64_t s) {
  const uint64_t q = blockIdx.x * (uint64_t)blockDim.x + threadIdx.x;
  if (q >= n / 2) return;
  const uint64_t i = (q / s) * 2 * s + (q % s);
  cmpx<W, NCMP>(rows, i, i + s);
}

// One half-cleaner stage of stride s over the first n rows of shared
// memory.  A warp's 32 pairs span 64 rows; row i's words sit in banks
// W i + c mod 32, so for s < 32 the first rows of the pairs would meet
// in half the banks they could use.  The lanes whose pairs lie in the
// upper 32 rows (bit 5 of i) read and write the second row first: each
// access then touches rows of both halves, twice the banks.
template <int W, int NCMP>
__device__ void smem_stage(uint32_t* sm, uint32_t n, uint32_t s) {
  for (uint32_t q = threadIdx.x; q < n / 2; q += blockDim.x) {
    const uint32_t i = ((q & ~(s - 1)) << 1) | (q & (s - 1));
    cmpx<W, NCMP>(sm, i, i + s, s < 32 && (i & 32));
  }
  __syncthreads();
}

// A level's first stage with its reversal fused (flip_quad) over
// segments of 2h rows of shared memory; a one-row run reverses to itself,
// so for h = 1 the flip is a plain stage.
template <int W, int NCMP>
__device__ void smem_flip(uint32_t* sm, uint32_t n, uint32_t h) {
  if (h == 1) {
    smem_stage<W, NCMP>(sm, n, 1);
    return;
  }
  const uint32_t quads = h / 2;
  for (uint32_t q = threadIdx.x; q < n / 4; q += blockDim.x)
    flip_quad<W, NCMP>(sm, (q / quads) * 2 * h, h, q % quads);
  __syncthreads();
}

inline unsigned blocks_for(uint64_t n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

inline uint32_t log2_exact(uint64_t v) {
  uint32_t l = 0;
  while ((1ull << l) < v) ++l;
  return l;
}

// ---- One schedule for K4, K5 and K7 --------------------------------------
//
// The network's stages (rows of 9 words compared on 8, the reversal fused
// into each level's first stage, a swap only on a strict lex_gt, the
// shared-memory stages smem_stage and smem_flip), grouped into few passes
// over the rows.  With a tile of TILE = kTile = 1024 rows (36 KiB of
// shared memory; 128 blocks at the flush shape of 2^17 rows, about one
// an SM) and N > TILE:
//   1. one tile launch stages the operand and runs every level whose
//      segments (2h rows) lie within a tile: h = P .. TILE/2.  K7's
//      operand is nine columns (word c of row i at cols[c*N + i]): the
//      launch reads each column coalesced in i into sm[i*9 + c] (9 is
//      odd, so a warp's stores meet no bank twice);
//   2. per later level, one group launch runs every stage of stride
//      >= TILE.  A segment of 2h rows is G = 2h/TILE tiles; those stages
//      pair rows whose indices differ only in the tile bits, except the
//      fused reversal, which pairs row k with 2h-1-k and so also
//      complements the offset o within the tile.  A block therefore
//      loads a set closed under all of them: L = TILE/(2G) offsets
//      o0..o0+L-1 and their complements TILE-1-o, in each of the
//      segment's G tiles (2GL = TILE rows).  It places the segment's
//      upper half reversed (JAX's concat(a, b[::-1]), _merge_level :70),
//      so that every stage of the level, the reversal's included, is a
//      plain half-cleaner in shared memory, and writes the rows back in
//      place: one pass for what took 1 + log2(h/TILE) launches;
//   3. per later level, one tile launch for the strides TILE/2 .. 1;
//   4. the last tile launch writes the same-key flags and, as its
//      epilogue, K5 the sorted rows, K4 only their word 8 (the carried
//      index), K7 the rows as nine columns (out[c*N + i], coalesced as
//      in 1).  K4's and K5's flags follow _merged_with_same (bitonic.py
//      :81-90): words 0-4 equal to the previous row's and word 4 not the
//      sentinel; K7's follow _same_key_mask (merge.py:42-51), with no
//      sentinel check, so K7's all-sentinel padding rows after the first
//      are flagged.  A tile's first row is compared with the previous
//      tile's last row, which is the lexicographic maximum of the
//      previous tile's rows: a tile launch only permutes rows within a
//      tile, and this one reads the work buffer, which none of its blocks
//      writes, so each block reduces the previous tile's rows itself and
//      no block waits on another.
// That is 1 + 2 log2(N/TILE) launches (15 at N = 2^17, 19 at 2^19) where
// the former network (one launch a stride >= TILE/2, with a staging and
// an epilogue launch) took 47 and 66.  Runs of P >= TILE rows (K4's
// (8, 2^15)) leave the first launch nothing to merge: it only stages the
// operand, and the call is 1 + 2 log2(K) launches (7 at K = 8).  Where
// N <= TILE the first launch is also the last (one block).
// The group needs G <= TILE/2, i.e. N <= TILE^2/2 (2^19 at TILE 1024); a
// level past that runs its stages of stride >= TILE one launch each
// (flip_stage_kernel, stage_kernel), so any power-of-two N stays correct.
//
// Bound: bytes, as for the network above.  Every pass reads and writes
// the 36 B rows once (a tile's words, or a group's chunks of L rows, in
// coalesced 4-byte accesses; K4's last pass writes 5 B a row), and the
// stages run in shared memory, where a stage moves 18 words per row
// pair: the shared-memory traffic of the 10 stages of a tile (55 in the
// first launch) is what the passes wait on, next to the launches
// themselves (PERF.md §6 has each pass's time).

constexpr uint32_t kRowW = 9;  // rows: words 0-7 compared, 8 carried

// A k5_tile_kernel launch's operand and output layout, and its flag rule.
constexpr uint32_t kColsIn = 1;   // src: nine columns of n rows (K7)
constexpr uint32_t kColsOut = 2;  // dst: nine columns of n rows (K7)
constexpr uint32_t kSameAll = 4;  // flags without the sentinel check (K7)

// Copies the block's tile * 9 words, word e from load(e) to store(e, v),
// nine loads in flight a thread (one block an SM holds too few warps to
// hide one load at a time); tile a multiple of blockDim.x.
template <typename Load, typename Store>
__device__ __forceinline__ void k5_copy(uint32_t tile, Load load,
                                        Store store) {
  for (uint32_t e0 = threadIdx.x; e0 < tile * kRowW;
       e0 += kRowW * blockDim.x) {
    uint32_t v[kRowW];
#pragma unroll
    for (uint32_t u = 0; u < kRowW; ++u) v[u] = load(e0 + u * blockDim.x);
#pragma unroll
    for (uint32_t u = 0; u < kRowW; ++u) store(e0 + u * blockDim.x, v[u]);
  }
}

// Words 0-4 of the lexicographically largest of `rows` rows at `src`,
// into `out` (shared) for every thread; blockDim a multiple of 32.
__device__ void k5_max5(const uint32_t* src, uint32_t rows, uint32_t* out) {
  __shared__ uint32_t part[32][5];
  uint32_t m[5] = {0, 0, 0, 0, 0};
  for (uint32_t i = threadIdx.x; i < rows; i += blockDim.x) {
    uint32_t r[5];
#pragma unroll
    for (int c = 0; c < 5; ++c) r[c] = src[(uint64_t)i * kRowW + c];
    if (lex_gt<5, 5>(r, m)) {
#pragma unroll
      for (int c = 0; c < 5; ++c) m[c] = r[c];
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    uint32_t y[5];
#pragma unroll
    for (int c = 0; c < 5; ++c) y[c] = __shfl_down_sync(0xffffffffu, m[c], o);
    if (lex_gt<5, 5>(y, m)) {
#pragma unroll
      for (int c = 0; c < 5; ++c) m[c] = y[c];
    }
  }
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int c = 0; c < 5; ++c) part[threadIdx.x >> 5][c] = m[c];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t best = 0;
    for (uint32_t w = 1; w < blockDim.x / 32; ++w)
      if (lex_gt<5, 5>(part[w], part[best])) best = w;
#pragma unroll
    for (int c = 0; c < 5; ++c) out[c] = part[best][c];
  }
  __syncthreads();
}

// One tile of `tile` rows per block, rows [b*tile, (b+1)*tile) of src:
// the strides s_start..1 of a level whose larger strides ran already
// (s_start = 0: none), then every level h = h_first, 2*h_first, ... with
// 2h <= tile, then the tile to dst.  With `same` (the last pass: src the
// work buffer or the operand, never an output) the same-key flags too,
// and with `idx` (K4's last pass; dst unused) each sorted row's word 8 to
// idx in place of the tile to dst.  src may equal dst otherwise.
// `layout` (kColsIn, kColsOut, kSameAll) names K7's ends; n is the rows
// of the whole operand, the columns' stride.  kColsIn with `same` takes
// one block: the previous tile's maximum is read as rows.
__global__ void __launch_bounds__(512, 2)
    k5_tile_kernel(const uint32_t* src, uint32_t* dst, uint32_t* idx,
                   uint32_t tile, uint32_t s_start, uint32_t h_first,
                   uint8_t* same, uint64_t n, uint32_t layout) {
  extern __shared__ uint32_t sm[];
  __shared__ uint32_t prev[5];
  const uint64_t off = (uint64_t)blockIdx.x * tile * kRowW;
  const uint64_t row0 = (uint64_t)blockIdx.x * tile;
  // In a column copy, element e is row e & (tile-1) of column e >> lt.
  const uint32_t lt = __ffs(tile) - 1, rmask = tile - 1;
  if (same && blockIdx.x > 0) k5_max5(src + off - tile * kRowW, tile, prev);
  if (layout & kColsIn) {
    k5_copy(
        tile,
        [&](uint32_t e) { return src[(e >> lt) * n + row0 + (e & rmask)]; },
        [&](uint32_t e, uint32_t v) {
          sm[(e & rmask) * kRowW + (e >> lt)] = v;
        });
  } else {
    k5_copy(
        tile, [&](uint32_t e) { return src[off + e]; },
        [&](uint32_t e, uint32_t v) { sm[e] = v; });
  }
  __syncthreads();
  for (uint32_t s = s_start; s >= 1; s >>= 1) smem_stage<9, 8>(sm, tile, s);
  for (uint32_t h = h_first; 2 * h <= tile; h <<= 1) {
    smem_flip<9, 8>(sm, tile, h);
    for (uint32_t s = h / 2; s >= 1; s >>= 1)
      smem_stage<9, 8>(sm, tile, s);
  }
  if (same) {
    const bool all = layout & kSameAll;
    for (uint32_t i = threadIdx.x; i < tile; i += blockDim.x) {
      const uint32_t* r = sm + i * kRowW;
      uint8_t flag = 0;
      if (i > 0 || blockIdx.x > 0) {
        const uint32_t* q = i > 0 ? r - kRowW : prev;
        bool eq = true;
#pragma unroll
        for (int c = 0; c < 5; ++c) eq = eq && r[c] == q[c];
        flag = eq && (all || r[4] != kSentinel);
      }
      same[row0 + i] = flag;
    }
  }
  if (idx) {
    for (uint32_t i = threadIdx.x; i < tile; i += blockDim.x)
      idx[row0 + i] = sm[i * kRowW + 8];
  } else if (layout & kColsOut) {
    k5_copy(
        tile, [&](uint32_t e) { return sm[(e & rmask) * kRowW + (e >> lt)]; },
        [&](uint32_t e, uint32_t v) {
          dst[(e >> lt) * n + row0 + (e & rmask)] = v;
        });
  } else {
    k5_copy(
        tile, [&](uint32_t e) { return sm[e]; },
        [&](uint32_t e, uint32_t v) { dst[off + e] = v; });
  }
}

// Every stage of stride >= tile of one level, in place on `rows`:
// segments of g tiles (2 <= g <= tile/2); block = (segment, offset block),
// holding l = 2^log_l = tile/(2g) offsets o0.. and their complements in
// each of the segment's tiles — chunk c = 2t + side of l rows, side 1 the
// complements — reversed on load in the segment's upper half.
__global__ void __launch_bounds__(512, 2)
    k5_group_kernel(uint32_t* rows, uint32_t tile, uint32_t g,
                    uint32_t log_l) {
  extern __shared__ uint32_t sm[];
  const uint32_t l = 1u << log_l;
  const uint64_t seg_base = (uint64_t)(blockIdx.x / g) * g * tile;
  const uint32_t o0 = (blockIdx.x % g) * l;
  // Local row r (chunk r >> log_l, row j of it) -> its row in `rows`.
  auto global_row = [&](uint32_t r) -> uint64_t {
    const uint32_t c = r >> log_l, j = r & (l - 1);
    return seg_base + (uint64_t)(c >> 1) * tile +
           ((c & 1) ? tile - o0 - l + j : o0 + j);
  };
  // Word e of local row r = e / 9: its word in `rows`.
  auto global_word = [&](uint32_t e) -> uint64_t {
    const uint32_t r = e / kRowW;
    return global_row(r) * kRowW + (e - r * kRowW);
  };
  // Upper half: tile t -> 3g/2-1-t, offset o -> tile-1-o (the other
  // side, row l-1-j of its chunk).
  auto slot_word = [&](uint32_t e) -> uint32_t {
    const uint32_t r = e / kRowW, c = r >> log_l, t = c >> 1;
    const uint32_t slot =
        t < g / 2 ? r
                  : (((3 * g / 2 - 1 - t) << 1 | (~c & 1)) << log_l) |
                        (l - 1 - (r & (l - 1)));
    return slot * kRowW + (e - r * kRowW);
  };
  k5_copy(
      tile, [&](uint32_t e) { return rows[global_word(e)]; },
      [&](uint32_t e, uint32_t v) { sm[slot_word(e)] = v; });
  __syncthreads();
  for (uint32_t s = tile / 2; s >= 2 * l; s >>= 1)
    smem_stage<9, 8>(sm, tile, s);
  k5_copy(
      tile, [&](uint32_t e) { return sm[e]; },
      [&](uint32_t e, uint32_t v) { rows[global_word(e)] = v; });
}

// K5 (out: the sorted rows) or K4 (idx: their word 8; out null), with
// the same-key flags; work holds n*9 words.  With `cols` (K7) the operand
// and out are nine columns of n rows and the flags K7's.
int k5_merge_rows(const uint32_t* stacks, uint64_t n, uint64_t p,
                  uint32_t* work, uint32_t* out, uint32_t* idx,
                  uint8_t* same, bool cols, cudaStream_t st) {
  const uint32_t tile = (uint32_t)(n < kTile ? n : kTile);
  const unsigned blocks = (unsigned)(n / tile);
  const unsigned threads = tile < 2 ? 1 : tile / 2;
  const size_t smem = (size_t)tile * kRowW * sizeof(uint32_t);
  const uint32_t last_layout = cols ? kColsOut | kSameAll : 0;
  uint64_t h = p;  // the first level past the first launch's tiles
  while (2 * h <= tile) h <<= 1;
  bool last = h >= n;
  k5_tile_kernel<<<blocks, threads, smem, st>>>(
      stacks, last ? out : work, last ? idx : nullptr, tile, 0,
      (uint32_t)(p < tile ? p : tile), last ? same : nullptr, n,
      (cols ? kColsIn : 0) | (last ? last_layout : 0));
  for (; h < n; h <<= 1) {
    const uint64_t g = 2 * h / tile;
    if (g <= tile / 2) {
      k5_group_kernel<<<blocks, threads, smem, st>>>(
          work, tile, (uint32_t)g, log2_exact(tile / (2 * g)));
    } else {
      flip_stage_kernel<9, 8><<<blocks_for(n / 4), kThreads, 0, st>>>(
          work, n, h);
      for (uint64_t s = h >> 1; s >= tile; s >>= 1)
        stage_kernel<9, 8><<<blocks_for(n / 2), kThreads, 0, st>>>(work, n,
                                                                    s);
    }
    last = 2 * h == n;
    k5_tile_kernel<<<blocks, threads, smem, st>>>(
        work, last ? out : work, last ? idx : nullptr, tile, tile / 2, tile,
        last ? same : nullptr, n, last ? last_layout : 0);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K4: stacks (K,P,9) u32 -> idx (K*P,) u32, the sorted rows' word 8, +
// same (K*P,) bytes 0/1; work holds K*P*9 u32.  K5's schedule with the
// index epilogue (see "One schedule for K4, K5 and K7").
// Bound: bytes (the stack read once, the index and the flags written
// once).  Counted as "K4" by ops/bitonic.py merge_runs_perm_kernel.
int dbeel_bitonic_perm(const uint32_t* stacks, uint32_t k, uint32_t p,
                       uint32_t* work, uint32_t* idx, uint8_t* same,
                       void* stream) {
  return k5_merge_rows(stacks, (uint64_t)k * p, p, work, nullptr, idx, same,
                       false, (cudaStream_t)stream);
}

// K5: stacks (K,P,9) u32 -> out (K*P, 9) u32, the whole sorted stack, +
// same (K*P,) bytes 0/1; work holds K*P*9 u32.  The flush sort
// (sort_stack_kernel) is K = N rows, P = 1.  See "One schedule for K4, K5
// and K7".  Bound: bytes (the stack read once, the sorted stack and the
// flags written once).  Counted as "K5" by ops/bitonic.py
// merge_runs_kernel.
int dbeel_bitonic_merge_rows(const uint32_t* stacks, uint32_t k, uint32_t p,
                             uint32_t* work, uint32_t* out, uint8_t* same,
                             void* stream) {
  return k5_merge_rows(stacks, (uint64_t)k * p, p, work, out, nullptr, same,
                       false, (cudaStream_t)stream);
}

// K7: cols (9, N) u32 — nine operand columns, N a power of two >= 8 —
// -> out (9, N) u32, the columns sorted lexicographically on the first
// eight, + same (N,) bytes 0/1 over columns 0-4 (no sentinel check);
// work holds N*9 u32.  K5's schedule with P = 1, a column prologue and a
// column epilogue (see "One schedule for K4, K5 and K7"): 19 launches at
// N = 2^19.  Bound: bytes (the columns read once, the sorted columns and
// the flags written once).  Counted as "K7" by ops/merge.py
// sort_dedup_kernel.
int dbeel_bitonic_sort_dedup_cols(const uint32_t* cols, uint32_t n,
                                  uint32_t* work, uint32_t* out,
                                  uint8_t* same, void* stream) {
  return k5_merge_rows(cols, n, 1, work, out, nullptr, same, true,
                       (cudaStream_t)stream);
}

}  // extern "C"
