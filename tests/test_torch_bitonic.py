"""dbeel_tpu_torch's bitonic merge kernels (K1-K4) against dbeel_tpu's.

The same seeded numpy inputs go through the JAX functions (on the CPU
backend) and through the port's wrappers on ``cpu`` tensors, which run
the kernels' plain PyTorch versions: outputs must be bit-equal — padding
words, sentinel rows and full 8-column ties included — because the
port reproduces the JAX network stage for stage, not only its sorted
result.  The ``cuda`` cases hold each CUDA kernel against its plain
version on a card and skip without one.

K1, K2 and K3 run on the card as a merge-path merge
(csrc/merge_path.cu), not the network.  What allows it: where every word
of a row is compared (K1, K2, K3, K6), the network's output on sorted,
sentinel-padded runs is the rows' unique sorted sequence.  A hypothesis
test holds dbeel_tpu's K1, K2, K3 and K6 to a numpy model that sorts the
rows with np.lexsort;
the ``cuda`` cases hold the merge-path kernels to their plain versions
on the same generator and at the main path's shapes.  K4 runs on the
card as K5's network schedule with an index-only epilogue: its output is
K5's word 8 and the same flags, an identity held here on the plain
versions.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from dbeel_tpu.ops import bitonic as jb
from dbeel_tpu.storage import columnar as jcol
from dbeel_tpu_torch.ops import bitonic as tb
from dbeel_tpu_torch.storage import columnar as tcol

SENT = 0xFFFFFFFF


def _runs(rng, j, k, p, words, hi, counts, salt=0.1):
    """Sentinel-padded sorted runs (j, k, p[, words]) u32 with heavy
    duplicates (values below ``hi``) and 0xFFFFFFFF inside valid rows
    (at rate ``salt``)."""
    shape = (j, k, p) + ((words,) if words > 1 else ())
    out = np.full(shape, SENT, dtype=np.uint32)
    for jj in range(j):
        for r in range(k):
            c = int(counts[jj, r])
            v = rng.integers(0, hi, size=(c, words), dtype=np.uint64)
            v[rng.random(c) < salt] = SENT
            v = v[np.lexsort(v.T[::-1])] if c else v
            out[jj, r, :c] = v if words > 1 else v[:, 0]
    return out


def _counts(rng, j, k, p):
    c = rng.integers(0, p + 1, size=(j, k)).astype(np.uint32)
    c[0, 0] = 0  # an empty run
    c[-1, -1] = p  # a full one
    return c


def _t(a):
    return tb.to_tensor(a, "cpu")


# (J, K, P): K in {1, 2, 8, 16}, P from 8 to 1024, batches with empty slots.
PACKED_SHAPES = [(1, 1, 8), (2, 2, 16), (3, 8, 64), (2, 16, 32), (1, 2, 1024)]


@pytest.mark.parametrize("j,k,p", PACKED_SHAPES)
def test_prefix32_packed_bit_equal(j, k, p):
    rng = np.random.default_rng(100 + k * p)
    counts = _counts(rng, j, k, p)
    vals = _runs(rng, j, k, p, 1, max(2, p // 4), counts)
    for pack_bits in sorted({jb.rid_pack_bits(k), 16}):
        want = np.asarray(
            jb.merge_runs_prefix32_packed_batch_kernel(vals, counts, pack_bits)
        )
        got = tb.to_numpy(
            tb.merge_runs_prefix32_packed_batch_kernel(
                _t(vals), _t(counts), pack_bits
            )
        )
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("j,k,p", PACKED_SHAPES)
def test_prefix64_packed_bit_equal(j, k, p):
    rng = np.random.default_rng(200 + k * p)
    counts = _counts(rng, j, k, p)
    pre = _runs(rng, j, k, p, 2, 3, counts)
    pack_bits = jb.rid_pack_bits(k)
    want = np.asarray(
        jb.merge_runs_prefix64_packed_batch_kernel(pre, counts, pack_bits)
    )
    got = tb.to_numpy(
        tb.merge_runs_prefix64_packed_batch_kernel(
            _t(pre), _t(counts), pack_bits
        )
    )
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize(
    "k,p,out_rows", [(1, 8, 8), (2, 16, 24), (8, 128, 512), (16, 64, 1024),
                     (2, 1024, 2048)]
)
def test_prefix_top_bit_equal(k, p, out_rows):
    rng = np.random.default_rng(300 + k * p)
    counts = _counts(rng, 1, k, p)
    pre = _runs(rng, 1, k, p, 2, 5, counts)[0]
    want = np.asarray(jb.merge_runs_prefix_kernel(pre, counts[0], out_rows))
    got = tb.to_numpy(
        tb.merge_runs_prefix_kernel(_t(pre), _t(counts[0]), out_rows)
    )
    np.testing.assert_array_equal(got, want)


def _stacks(rng, k, p):
    """(k, p, 9) runs sorted on cols 0-7 with many full 8-column ties
    (distinct carried index in col 8) and sentinel-padded tails."""
    st = rng.integers(0, 2, size=(k, p, 9), dtype=np.uint64).astype(np.uint32)
    st[..., 8] = rng.permutation(k * p).reshape(k, p).astype(np.uint32)
    for r in range(k):
        st[r] = st[r][np.lexsort(st[r, :, :8].T[::-1])]
        st[r, rng.integers(0, p + 1):] = SENT
    return st


# (K, P): K = 1, P below, at and above K5's 1024-row tile on the card.
K4_SHAPES = [(1, 8), (64, 16), (2, 1024), (4, 2048), (8, 512)]


@pytest.mark.parametrize(
    "k,p", [(1, 8), (2, 16), (8, 64), (16, 32), (2, 1024), (4, 2048)]
)
def test_perm_bit_equal_with_full_ties(k, p):
    st = _stacks(np.random.default_rng(400 + k * p), k, p)
    want_idx, want_same = jb.merge_runs_perm_kernel(st)
    got_idx, got_same = tb.merge_runs_perm_kernel(_t(st))
    np.testing.assert_array_equal(tb.to_numpy(got_idx), np.asarray(want_idx))
    np.testing.assert_array_equal(got_same.numpy(), np.asarray(want_same))


@pytest.mark.parametrize("k,p", K4_SHAPES)
def test_perm_is_merge_rows_word8(k, p):
    """What the card's K4 rests on: K4's output is K5's sorted stack's
    word 8 with K5's flags, under full 8-word ties and sentinel tails."""
    st = _t(_stacks(np.random.default_rng(450 + k * p), k, p))
    idx, same = tb.perm_plain(st)
    rows, rows_same = tb.merge_rows_plain(st)
    assert torch.equal(idx, rows[:, 8])
    assert torch.equal(same, rows_same)


def test_wrappers_refuse_bad_operands():
    vals = torch.zeros((1, 3, 8), dtype=torch.int32)  # K not a power of 2
    with pytest.raises(ValueError):
        tb.merge_runs_prefix32_packed_batch_kernel(
            vals, torch.zeros((1, 3), dtype=torch.int32), 2
        )
    with pytest.raises(ValueError):  # int64 operand
        tb.merge_runs_perm_kernel(torch.zeros((2, 8, 9), dtype=torch.int64))
    with pytest.raises(ValueError, match="pack_bits"):  # not a word divisor
        tb.merge_runs_prefix64_packed_batch_kernel(
            torch.zeros((1, 2, 8, 2), dtype=torch.int32),
            torch.zeros((1, 2), dtype=torch.int32), 3,
        )
    with pytest.raises(ValueError, match="pack_bits"):
        tb.merge_runs_prefix32_packed_batch_kernel(
            torch.zeros((1, 2, 8), dtype=torch.int32),
            torch.zeros((1, 2), dtype=torch.int32), 3,
        )


def _cols(rng, n_runs, per_run):
    """MergeColumns for both packages from one seeded set of runs."""
    from dbeel_tpu.storage.entry import encode_entry

    pieces = []
    for r in range(n_runs):
        keys = sorted({
            bytes(rng.integers(0, 4, size=int(rng.integers(1, 20)),
                               dtype=np.uint8))
            for _ in range(per_run)
        })
        recs = [encode_entry(k, b"v%d" % r, int(rng.integers(0, 50)))
                for k in keys]
        offs = np.cumsum([0] + [len(x) for x in recs[:-1]]).astype(np.uint64)
        ks = np.array([len(k) for k in keys], np.uint32)
        fs = np.array([len(x) for x in recs], np.uint32)
        pieces.append((b"".join(recs), offs, ks, fs))
    return jcol.assemble_columns(pieces), tcol.assemble_columns(pieces)


def test_host_helpers_equal_reference():
    rng = np.random.default_rng(7)
    jc, tc = _cols(rng, 5, 60)
    run_counts = np.bincount(tc.src).tolist()
    for a, b in zip(
        jb.stage_prefixes(jc, run_counts), tb.stage_prefixes(tc, run_counts)
    ):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert jb.stage_prefixes(jc, run_counts, 16, 256)[0].shape == (
        tb.stage_prefixes(tc, run_counts, 16, 256)[0].shape
    )
    np.testing.assert_array_equal(
        jb.build_run_stacks(jc, run_counts), tb.build_run_stacks(tc, run_counts)
    )
    for k2 in (1, 2, 3, 16, 17, 256, 257, 65536):
        assert tb.rid_pack_bits(k2) == jb.rid_pack_bits(k2)
    with pytest.raises(ValueError):
        tb.rid_pack_bits(65537)
    for n in (0, 1, 5, 8, 1000):
        assert tb._pow2(n) == jb._pow2(n)
    words = rng.integers(0, 1 << 32, size=40, dtype=np.uint64).astype(np.uint32)
    for pack_bits in (1, 2, 4, 8, 16):
        np.testing.assert_array_equal(
            tb.unpack_rids(words, pack_bits, 70),
            jb.unpack_rids(words, pack_bits, 70),
        )
    np.testing.assert_array_equal(
        tb.device_merge_prefix_order(tc, run_counts, "cpu"),
        jb.device_merge_prefix_order(jc, run_counts),
    )
    for a, b in zip(
        tb.device_merge_sorted_runs(tc, run_counts, "cpu"),
        jb.device_merge_sorted_runs(jc, run_counts),
    ):
        np.testing.assert_array_equal(a, b)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("j,k,p", PACKED_SHAPES + [(4, 8, 131072)])
def test_cuda_kernels_equal_plain(cuda_device, j, k, p):
    rng = np.random.default_rng(500 + k * p)
    counts = _counts(rng, j, k, p)
    vals = _runs(rng, j, k, p, 1, max(2, p // 4), counts)
    pre = _runs(rng, j, k, p, 2, 3, counts)
    pack_bits = tb.rid_pack_bits(k)
    for dev_fn, plain_fn, operand in (
        (tb.merge_runs_prefix32_packed_batch_kernel,
         tb.prefix32_packed_plain, vals),
        (tb.merge_runs_prefix64_packed_batch_kernel,
         tb.prefix64_packed_plain, pre),
    ):
        x = tb.to_tensor(operand, cuda_device)
        c = tb.to_tensor(counts, cuda_device)
        assert torch.equal(dev_fn(x, c, pack_bits), plain_fn(x, c, pack_bits))
    x = tb.to_tensor(pre[0], cuda_device)
    c = tb.to_tensor(counts[0], cuda_device)
    assert torch.equal(
        tb.merge_runs_prefix_kernel(x, c, k * p),
        tb.prefix_top_plain(x, c, k * p),
    )
    st = tb.to_tensor(_stacks(rng, k, min(p, 4096)), cuda_device)
    for got, want in zip(tb.merge_runs_perm_kernel(st), tb.perm_plain(st)):
        assert torch.equal(got, want)
    torch.cuda.synchronize()


# ----------------------------------------------------------------------
# The merge-path equivalence: a row's every word compared (W == NCMP)
# ----------------------------------------------------------------------


def _merge_case(seed, j, k, p, hi, salt, words):
    """_runs with an empty run, a full run and, for J > 1, every other
    job empty."""
    rng = np.random.default_rng(seed)
    counts = _counts(rng, j, k, p)
    if j > 1:
        counts[1::2] = 0
    return _runs(rng, j, k, p, words, hi, counts, salt), counts


def _model_idx(runs, counts):
    """Per job, the idx column of the rows (key words..., idx) sorted
    with np.lexsort: (J, K*P) u32."""
    j, k, p = runs.shape[:3]
    keys = runs.reshape(j, k * p, -1).astype(np.uint64)
    pos = np.arange(p, dtype=np.uint64)
    iota = np.arange(k, dtype=np.uint64)[:, None] * p + pos
    out = np.empty((j, k * p), np.uint32)
    for jj in range(j):
        idx = np.where(pos[None] < counts[jj][:, None], iota, SENT).ravel()
        cols = [idx] + [keys[jj, :, c] for c in range(keys.shape[2] - 1, -1, -1)]
        out[jj] = idx[np.lexsort(cols)]
    return out


def _model_packed(idx, p, pack_bits):
    """_pack_rids in numpy: run ids, pack_bits each, low bits first."""
    per = 32 // pack_bits
    j, n = idx.shape
    pad = np.full((j, (-n) % per), SENT, np.uint32)
    rid = (np.concatenate([idx, pad], 1).astype(np.uint64)
           >> np.uint64(p.bit_length() - 1)) & np.uint64((1 << pack_bits) - 1)
    shifts = np.arange(per, dtype=np.uint64) * np.uint64(pack_bits)
    return (rid.reshape(j, -1, per) << shifts).sum(-1).astype(np.uint32)


_merge_params = st.tuples(
    st.integers(0, 2**31),  # seed
    st.sampled_from([1, 2, 8, 16]),  # J
    st.sampled_from([1, 2, 8, 16]),  # K
    st.sampled_from([8, 16, 64, 256, 1024]),  # P
    st.integers(1, 5),  # hi: heavy duplicates
    st.sampled_from([0.0, 0.1, 0.5]),  # 0xFFFFFFFF salt
    st.floats(0.0, 1.0),  # where out_rows falls in [1, K*P]
)


@pytest.mark.parametrize("kernel", ["K1", "K2", "K3", "K6"])
@settings(max_examples=10, deadline=None, database=None)
@given(_merge_params)
def test_jax_merges_equal_lexsort_model(kernel, params):
    seed, j, k, p, hi, salt, frac = params
    if k * p * j > 1 << 14:  # keep each JAX compile small
        p = max(8, (1 << 14) // (k * j))
    words = 1 if kernel == "K1" else 2
    runs, counts = _merge_case(seed, j, k, p, hi, salt, words)
    idx = _model_idx(runs, counts)
    out_rows = max(1, min(k * p, int(frac * k * p)))
    if kernel in ("K1", "K2"):
        pb = jb.rid_pack_bits(k)
        fn = (jb.merge_runs_prefix32_packed_batch_kernel if kernel == "K1"
              else jb.merge_runs_prefix64_packed_batch_kernel)
        got, want = fn(runs, counts, pb), _model_packed(idx, p, pb)
    elif kernel == "K3":
        got = jb.merge_runs_prefix_kernel(runs[0], counts[0], out_rows)
        want = idx[0, :out_rows]
    else:
        got = jb.merge_runs_prefix_batch_kernel(runs, counts, out_rows)
        want = idx[:, :out_rows]
    np.testing.assert_array_equal(np.asarray(got), want)


# The generator's cases for the card: (seed, J, K, P, hi, salt, out_rows).
MERGE_PATH_CASES = [
    (1, 1, 2, 8, 1, 0.1, 5),
    (2, 8, 16, 64, 1, 0.1, 1000),
    (3, 2, 8, 1024, 3, 0.5, 1),
    (4, 16, 1, 256, 2, 0.0, 100),
    (5, 1, 16, 1024, 5, 0.1, 16 * 1024),
    (6, 2, 2, 8192, 1, 0.0, 3 * 2048 + 7),
    (7, 4, 8, 131072, 1 << 12, 0.01, 8 * 131072),  # K2's main-path shape
    (8, 1, 8, 1 << 18, 1 << 16, 0.01, 1 << 21),  # K3's main-path shape
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", MERGE_PATH_CASES)
def test_cuda_merge_path_equals_plain(cuda_device, case):
    seed, j, k, p, hi, salt, out_rows = case
    vals, counts1 = _merge_case(seed, j, k, p, hi, salt, 1)
    v = tb.to_tensor(vals, cuda_device)
    c1 = tb.to_tensor(counts1, cuda_device)
    runs, counts = _merge_case(seed, j, k, p, hi, salt, 2)
    x = tb.to_tensor(runs, cuda_device)
    c = tb.to_tensor(counts, cuda_device)
    for pb in sorted({tb.rid_pack_bits(k), 16}):
        got = tb.merge_runs_prefix32_packed_batch_kernel(v, c1, pb)
        assert torch.equal(got, tb.prefix32_packed_plain(v, c1, pb))
        got = tb.merge_runs_prefix64_packed_batch_kernel(x, c, pb)
        assert torch.equal(got, tb.prefix64_packed_plain(x, c, pb))
    got = tb.merge_runs_prefix_kernel(x[0], c[0], out_rows)
    assert torch.equal(got, tb.prefix_top_plain(x[0], c[0], out_rows))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("k,p", K4_SHAPES + [(8, 1 << 15), (8, 1 << 17)])
def test_cuda_k4_schedule_equals_plain(cuda_device, k, p):
    """K4 on K5's schedule (csrc/bitonic.cu k5_merge_rows, the index
    epilogue) bit-equal to the network: full 8-word ties, sentinel
    tails, runs below, at and above the 1024-row tile, the main path's
    (8, 2^15) and N = 2^20, past tile^2/2, where the last level runs its
    strides of a tile or more one launch each."""
    st = tb.to_tensor(_stacks(np.random.default_rng(600 + k * p), k, p),
                      cuda_device)
    before = tb.launches["K4"]
    got = tb.merge_runs_perm_kernel(st)
    assert tb.launches["K4"] == before + 1
    for g, w in zip(got, tb.perm_plain(st)):
        assert torch.equal(g, w)
    torch.cuda.synchronize()
