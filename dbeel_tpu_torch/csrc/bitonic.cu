// Bitonic merge network over K sorted runs — the compaction merge and
// flush sort kernels of dbeel_tpu_torch (K1 and K4-K7 of PERF.md), for
// Hopper (sm_90a).  K2 and K3 are merge-path merges (csrc/merge_path.cu).
//
// Replaces the jax.jit compare-exchange networks of dbeel_tpu/ops/bitonic.py:
//   K1 merge_runs_prefix32_packed_batch_kernel  (bitonic.py:235, body :202)
//   K4 merge_runs_perm_kernel                    (bitonic.py:104, :81)
//   K5 merge_runs_kernel / sort_stack_kernel     (bitonic.py:95, :114)
//   K6 merge_runs_prefix_batch_kernel            (bitonic.py:284)
//   K7 _sort_kernel + _same_key_mask    (dbeel_tpu/ops/merge.py:35, :42)
//
// Data: a flat array of N = J*K*P rows of W u32 words (W = 2, 3, 9),
// compared lexicographically on the first NCMP words (2, 3, 8).  The
// network is the JAX one exactly, not only its sorted result: per level
// l (runs of P_l = P << l rows), each odd run is reversed (JAX's
// concat(a, b[::-1]), _merge_level :70) and half-cleaner stages with
// strides P_l, P_l/2, ..., 1 swap a pair iff lex_gt(lo, hi) is strictly
// true (_bitonic_to_sorted :53).  Following the network bit for bit keeps
// the output equal even where rows tie on every compared word (K4 with
// long keys sharing a 16-byte prefix, a length, a ts and a source).  The
// reversal is fused into the first stage of each level: one thread owns
// the two pairs (t, h-1-t) a reversal would exchange, so no pass is
// spent on it.  The batch axis J of K1/K6 needs nothing: runs are
// pow2-sized and the levels stop at K*P rows, so no level's pair ever
// crosses a batch boundary.  K5's flush sort is the P = 1 case (every
// row its own run): a one-row run reverses to itself, so its first
// level's flip is a plain stage.  K7 is the same P = 1 network on nine
// separate operand columns: lax.sort of 9 u32 operands on 8 keys, with
// a staging pass from columns to rows before it and a column epilogue
// (plus _same_key_mask's flags) after it.
//
// Bound: bytes.  Each operand row is read once and each output word
// written once; the network does N/2 compare-exchanges per stage, a few
// integer ops each, far under the card's integer rate.  This
// first version runs strides >= TILE/2 as one global-memory launch per
// stage and every smaller stride of a level in one shared-memory tile
// launch (TILE rows of W words, <= 36 KiB), so a level costs
// (log2(2 P_l) - log2(TILE) + 2) passes over the rows.  It is not yet
// near the bound; PERF.md keeps its times.
//
// Interface: plain C, launched on the caller's stream, no allocation
// (the wrapper passes the work buffer), returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kSentinel = 0xFFFFFFFFu;
constexpr int kThreads = 256;

template <int W>
struct Tile;
template <>
struct Tile<2> {
  static constexpr uint32_t rows = 4096;  // 32 KiB
};
template <>
struct Tile<3> {
  static constexpr uint32_t rows = 2048;  // 24 KiB
};
template <>
struct Tile<9> {
  static constexpr uint32_t rows = 1024;  // 36 KiB
};

template <int W>
__device__ __forceinline__ void load_row(const uint32_t* base, uint64_t i,
                                         uint32_t (&r)[W]) {
#pragma unroll
  for (int c = 0; c < W; ++c) r[c] = base[i * W + c];
}

template <int W>
__device__ __forceinline__ void store_row(uint32_t* base, uint64_t i,
                                          const uint32_t (&r)[W]) {
#pragma unroll
  for (int c = 0; c < W; ++c) base[i * W + c] = r[c];
}

// a > b lexicographically over the first NCMP words (bitonic.py _lex_gt).
template <int W, int NCMP>
__device__ __forceinline__ bool lex_gt(const uint32_t (&a)[W],
                                       const uint32_t (&b)[W]) {
#pragma unroll
  for (int c = 0; c < NCMP; ++c) {
    if (a[c] != b[c]) return a[c] > b[c];
  }
  return false;
}

// Compare-exchange of rows i < j: the smaller lands at i; equal rows stay.
template <int W, int NCMP>
__device__ __forceinline__ void cmpx(uint32_t* rows, uint64_t i, uint64_t j) {
  uint32_t a[W], b[W];
  load_row<W>(rows, i, a);
  load_row<W>(rows, j, b);
  if (lex_gt<W, NCMP>(a, b)) {
    store_row<W>(rows, i, b);
    store_row<W>(rows, j, a);
  }
}

// First stage of a level, reversal fused: segment [a; b] of 2h rows
// starting at `base`; the reversed b is rb[k] = rows[base + 2h - 1 - k].
// Quad t (t < h/2) owns the pairs k = t and k = h-1-t: it reads the four
// rows a[t], a[h-1-t], b[t], b[h-1-t] and writes the stage's results
// to positions base+k (lo) and base+h+k (hi) for both k.
template <int W, int NCMP>
__device__ __forceinline__ void flip_quad(uint32_t* rows, uint64_t base,
                                          uint64_t h, uint64_t t) {
  uint32_t a0[W], a1[W], b0[W], b1[W];
  load_row<W>(rows, base + t, a0);
  load_row<W>(rows, base + h - 1 - t, a1);
  load_row<W>(rows, base + h + t, b0);
  load_row<W>(rows, base + 2 * h - 1 - t, b1);
  // pair k = t: (a[t], rb[t] = b[h-1-t] = b1)
  if (lex_gt<W, NCMP>(a0, b1)) {
    store_row<W>(rows, base + t, b1);
    store_row<W>(rows, base + h + t, a0);
  } else {
    store_row<W>(rows, base + t, a0);
    store_row<W>(rows, base + h + t, b1);
  }
  // pair k = h-1-t: (a[h-1-t] = a1, rb[h-1-t] = b[t] = b0)
  if (lex_gt<W, NCMP>(a1, b0)) {
    store_row<W>(rows, base + h - 1 - t, b0);
    store_row<W>(rows, base + 2 * h - 1 - t, a1);
  } else {
    store_row<W>(rows, base + h - 1 - t, a1);
    store_row<W>(rows, base + 2 * h - 1 - t, b0);
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

// Every stage of stride <= s_start on one tile of `tile` rows held in
// shared memory (2 * s_start <= tile).  With `flip_first` the first
// stage is the level's fused reversal at stride s_start.
template <int W, int NCMP>
__global__ void tile_kernel(uint32_t* rows, uint32_t tile, uint32_t s_start,
                            int flip_first) {
  extern __shared__ uint32_t sm[];
  const uint64_t off = (uint64_t)blockIdx.x * tile * W;
  for (uint32_t e = threadIdx.x; e < tile * W; e += blockDim.x)
    sm[e] = rows[off + e];
  __syncthreads();
  uint32_t s = s_start;
  // A one-row run reverses to itself: then the plain stage is the flip.
  if (flip_first && s >= 2) {
    const uint32_t quads = s / 2;
    for (uint32_t q = threadIdx.x; q < tile / 4; q += blockDim.x)
      flip_quad<W, NCMP>(sm, (uint64_t)(q / quads) * 2 * s, s, q % quads);
    __syncthreads();
    s >>= 1;
  }
  for (; s >= 1; s >>= 1) {
    for (uint32_t q = threadIdx.x; q < tile / 2; q += blockDim.x) {
      const uint32_t i = (q / s) * 2 * s + (q % s);
      cmpx<W, NCMP>(sm, i, i + s);
    }
    __syncthreads();
  }
  for (uint32_t e = threadIdx.x; e < tile * W; e += blockDim.x)
    rows[off + e] = sm[e];
}

// Stage the rows: copy `src_w` words per row from the operand and, when
// src_w < W, build the index column on the device (bitonic.py :140-146,
// :206-211): iota (run << logP) | pos for valid rows, SENTINEL past the
// run's count.  Row i = ((j * K) + r) * P + p.
template <int W>
__global__ void stage_rows_kernel(const uint32_t* src, int src_w,
                                  const uint32_t* counts, uint32_t log_k,
                                  uint32_t log_p, uint64_t n,
                                  uint32_t* rows) {
  const uint64_t i = blockIdx.x * (uint64_t)blockDim.x + threadIdx.x;
  if (i >= n) return;
  for (int c = 0; c < src_w; ++c) rows[i * W + c] = src[i * src_w + c];
  if (src_w < W) {
    const uint32_t p = (uint32_t)(i & ((1ull << log_p) - 1));
    const uint64_t jr = i >> log_p;  // j * K + r
    const uint32_t r = (uint32_t)(jr & ((1ull << log_k) - 1));
    rows[i * W + W - 1] = p < counts[jr] ? ((r << log_p) | p) : kSentinel;
  }
}

// _pack_rids (bitonic.py :181): per batch, the sorted index column's run
// ids ((idx >> logP) & mask), `per` = 32/pack_bits to a word, low bits
// first; the ragged tail pads with SENTINEL's run-id bits.
template <int W>
__global__ void pack_rids_kernel(const uint32_t* rows, uint64_t rows_per_b,
                                 uint64_t words_per_b, uint64_t total,
                                 uint32_t log_p, uint32_t pack_bits,
                                 uint32_t* out) {
  const uint64_t g = blockIdx.x * (uint64_t)blockDim.x + threadIdx.x;
  if (g >= total) return;
  const uint64_t j = g / words_per_b;
  const uint64_t w = g % words_per_b;
  const uint32_t per = 32 / pack_bits;
  const uint32_t mask = (1u << pack_bits) - 1;
  uint32_t word = 0;
  for (uint32_t e = 0; e < per; ++e) {
    const uint64_t n = w * per + e;
    const uint32_t idx =
        n < rows_per_b ? rows[(j * rows_per_b + n) * W + W - 1] : kSentinel;
    word |= ((idx >> log_p) & mask) << (e * pack_bits);
  }
  out[g] = word;
}

// K6 epilogue: per job j, the index column of its first out_rows
// rows, out[j, r] = rows[j * K*P + r][W-1].
template <int W>
__global__ void top_rows_kernel(const uint32_t* rows, uint64_t rows_per_j,
                                uint64_t out_rows, uint64_t total,
                                uint32_t* out) {
  const uint64_t g = blockIdx.x * (uint64_t)blockDim.x + threadIdx.x;
  if (g >= total) return;
  const uint64_t j = g / out_rows;
  out[g] = rows[(j * rows_per_j + g % out_rows) * W + W - 1];
}

// K4 epilogue (_merged_with_same :81-90): index column 8, and same-key
// flags over words 0-4 with the sentinel check on word 4.
__global__ void perm_same_kernel(const uint32_t* rows, uint64_t n,
                                 uint32_t* idx, uint8_t* same) {
  const uint64_t i = blockIdx.x * (uint64_t)blockDim.x + threadIdx.x;
  if (i >= n) return;
  idx[i] = rows[i * 9 + 8];
  uint8_t s = 0;
  if (i > 0) {
    bool eq = true;
#pragma unroll
    for (int c = 0; c < 5; ++c) eq = eq && rows[i * 9 + c] == rows[(i - 1) * 9 + c];
    s = eq && rows[i * 9 + 4] != kSentinel;
  }
  same[i] = s;
}

// K5 epilogue (_merged_with_same :81-90, whole rows): perm_same_kernel
// with all 9 words of each sorted row copied out instead of column 8.
__global__ void rows_same_kernel(const uint32_t* rows, uint64_t n,
                                 uint32_t* out, uint8_t* same) {
  const uint64_t i = blockIdx.x * (uint64_t)blockDim.x + threadIdx.x;
  if (i >= n) return;
#pragma unroll
  for (int c = 0; c < 9; ++c) out[i * 9 + c] = rows[i * 9 + c];
  uint8_t s = 0;
  if (i > 0) {
    bool eq = true;
#pragma unroll
    for (int c = 0; c < 5; ++c) eq = eq && rows[i * 9 + c] == rows[(i - 1) * 9 + c];
    s = eq && rows[i * 9 + 4] != kSentinel;
  }
  same[i] = s;
}

// K7 staging: nine separate operand columns (column c at cols + c*n)
// into rows of nine words.
__global__ void cols_to_rows_kernel(const uint32_t* cols, uint64_t n,
                                    uint32_t* rows) {
  const uint64_t i = blockIdx.x * (uint64_t)blockDim.x + threadIdx.x;
  if (i >= n) return;
#pragma unroll
  for (int c = 0; c < 9; ++c) rows[i * 9 + c] = cols[c * n + i];
}

// K7 epilogue: the sorted rows back as nine columns, and
// _same_key_mask (merge.py:42) — same[i] = words 0-4 of row i equal
// those of row i-1, with no sentinel check (unlike K4/K5's epilogues).
__global__ void rows_to_cols_same_kernel(const uint32_t* rows, uint64_t n,
                                         uint32_t* cols, uint8_t* same) {
  const uint64_t i = blockIdx.x * (uint64_t)blockDim.x + threadIdx.x;
  if (i >= n) return;
#pragma unroll
  for (int c = 0; c < 9; ++c) cols[c * n + i] = rows[i * 9 + c];
  uint8_t s = 0;
  if (i > 0) {
    bool eq = true;
#pragma unroll
    for (int c = 0; c < 5; ++c) eq = eq && rows[i * 9 + c] == rows[(i - 1) * 9 + c];
    s = eq;
  }
  same[i] = s;
}

inline unsigned blocks_for(uint64_t n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

inline uint32_t log2_exact(uint64_t v) {
  uint32_t l = 0;
  while ((1ull << l) < v) ++l;
  return l;
}

// log2(K) merge levels over n = J*K*P rows (K, P powers of two).
template <int W, int NCMP>
cudaError_t run_network(uint32_t* rows, uint64_t n, uint64_t k, uint64_t p,
                        cudaStream_t st) {
  const uint64_t tile = n < Tile<W>::rows ? n : Tile<W>::rows;
  const unsigned tile_threads = (unsigned)(tile / 2 < 512 ? tile / 2 : 512);
  const size_t smem = tile * W * sizeof(uint32_t);
  const unsigned tiles = (unsigned)(n / tile);
  for (uint64_t h = p; h < k * p; h <<= 1) {
    if (2 * h <= tile) {
      tile_kernel<W, NCMP><<<tiles, tile_threads, smem, st>>>(
          rows, (uint32_t)tile, (uint32_t)h, 1);
    } else {
      flip_stage_kernel<W, NCMP><<<blocks_for(n / 4), kThreads, 0, st>>>(
          rows, n, h);
      uint64_t s = h >> 1;
      for (; 2 * s > tile; s >>= 1)
        stage_kernel<W, NCMP><<<blocks_for(n / 2), kThreads, 0, st>>>(
            rows, n, s);
      tile_kernel<W, NCMP><<<tiles, tile_threads, smem, st>>>(
          rows, (uint32_t)tile, (uint32_t)s, 0);
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

template <int W, int NCMP>
int packed_merge(const uint32_t* operand, const uint32_t* counts, uint32_t j,
                 uint32_t k, uint32_t p, uint32_t pack_bits, uint32_t* work,
                 uint32_t* out, cudaStream_t st) {
  const uint64_t n = (uint64_t)j * k * p;
  const uint32_t log_p = log2_exact(p);
  stage_rows_kernel<W><<<blocks_for(n), kThreads, 0, st>>>(
      operand, W - 1, counts, log2_exact(k), log_p, n, work);
  cudaError_t err = run_network<W, NCMP>(work, n, k, p, st);
  if (err != cudaSuccess) return (int)err;
  const uint64_t per = 32 / pack_bits;
  const uint64_t rows_per_b = (uint64_t)k * p;
  const uint64_t words_per_b = (rows_per_b + per - 1) / per;
  pack_rids_kernel<W><<<blocks_for(j * words_per_b), kThreads, 0, st>>>(
      work, rows_per_b, words_per_b, j * words_per_b, log_p, pack_bits, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K1: vals (J,K,P) u32, counts (J,K) u32 -> out (J, ceil(K*P/(32/pack_bits)))
// u32; work holds J*K*P*2 u32.
int dbeel_bitonic_prefix32_packed(const uint32_t* vals, const uint32_t* counts,
                                  uint32_t j, uint32_t k, uint32_t p,
                                  uint32_t pack_bits, uint32_t* work,
                                  uint32_t* out, void* stream) {
  return packed_merge<2, 2>(vals, counts, j, k, p, pack_bits, work, out,
                            (cudaStream_t)stream);
}

// K6: prefixes (J,K,P,2) u32, counts (J,K) u32 -> out (J, out_rows) u32,
// per job packed (run << logP) | pos with its iota restarting at 0 (the
// JAX vmap of K3's body); work holds J*K*P*3 u32.  Bound: bytes (the
// prefixes read once, J*out_rows words written).  Counted as "K6" by
// ops/bitonic.py merge_runs_prefix_batch_kernel.
int dbeel_bitonic_prefix_top_batch(const uint32_t* prefixes,
                                   const uint32_t* counts, uint32_t j,
                                   uint32_t k, uint32_t p, uint32_t out_rows,
                                   uint32_t* work, uint32_t* out,
                                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const uint64_t n = (uint64_t)j * k * p;
  stage_rows_kernel<3><<<blocks_for(n), kThreads, 0, st>>>(
      prefixes, 2, counts, log2_exact(k), log2_exact(p), n, work);
  cudaError_t err = run_network<3, 3>(work, n, k, p, st);
  if (err != cudaSuccess) return (int)err;
  const uint64_t total = (uint64_t)j * out_rows;
  if (total)
    top_rows_kernel<3><<<blocks_for(total), kThreads, 0, st>>>(
        work, (uint64_t)k * p, out_rows, total, out);
  return (int)cudaGetLastError();
}

// K4: stacks (K,P,9) u32 -> idx (K*P,) u32 + same (K*P,) bytes 0/1;
// work holds K*P*9 u32.
int dbeel_bitonic_perm(const uint32_t* stacks, uint32_t k, uint32_t p,
                       uint32_t* work, uint32_t* idx, uint8_t* same,
                       void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const uint64_t n = (uint64_t)k * p;
  stage_rows_kernel<9><<<blocks_for(n), kThreads, 0, st>>>(
      stacks, 9, nullptr, log2_exact(k), log2_exact(p), n, work);
  cudaError_t err = run_network<9, 8>(work, n, k, p, st);
  if (err != cudaSuccess) return (int)err;
  perm_same_kernel<<<blocks_for(n), kThreads, 0, st>>>(work, n, idx, same);
  return (int)cudaGetLastError();
}

// K5: stacks (K,P,9) u32 -> out (K*P, 9) u32, the whole sorted stack, +
// same (K*P,) bytes 0/1; work holds K*P*9 u32.  The flush sort
// (sort_stack_kernel) is K = N rows, P = 1.  Bound: bytes (the stack read
// once, the sorted stack and the flags written once).  Counted as "K5" by
// ops/bitonic.py merge_runs_kernel.
int dbeel_bitonic_merge_rows(const uint32_t* stacks, uint32_t k, uint32_t p,
                             uint32_t* work, uint32_t* out, uint8_t* same,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const uint64_t n = (uint64_t)k * p;
  stage_rows_kernel<9><<<blocks_for(n), kThreads, 0, st>>>(
      stacks, 9, nullptr, log2_exact(k), log2_exact(p), n, work);
  cudaError_t err = run_network<9, 8>(work, n, k, p, st);
  if (err != cudaSuccess) return (int)err;
  rows_same_kernel<<<blocks_for(n), kThreads, 0, st>>>(work, n, out, same);
  return (int)cudaGetLastError();
}

// K7: cols (9, N) u32 — nine operand columns, N a power of two >= 8 —
// -> out (9, N) u32, the columns sorted lexicographically on the first
// eight, + same (N,) bytes 0/1 over columns 0-4; work holds N*9 u32.
// Bound: bytes (the columns read once, the sorted columns and the flags
// written once).  Counted as "K7" by ops/merge.py sort_dedup_kernel.
int dbeel_bitonic_sort_dedup_cols(const uint32_t* cols, uint32_t n,
                                  uint32_t* work, uint32_t* out,
                                  uint8_t* same, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cols_to_rows_kernel<<<blocks_for(n), kThreads, 0, st>>>(cols, n, work);
  cudaError_t err = run_network<9, 8>(work, n, n, 1, st);
  if (err != cudaSuccess) return (int)err;
  rows_to_cols_same_kernel<<<blocks_for(n), kThreads, 0, st>>>(work, n, out,
                                                               same);
  return (int)cudaGetLastError();
}

}  // extern "C"
