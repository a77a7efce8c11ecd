"""dbeel_tpu_torch's query plane against dbeel_tpu's: the K8 filter and
aggregate kernels (plain versions against the jitted ``_kernels()``
table), the MessagePack codec against the ``msgpack`` package, and the
golden spec evaluator of ``query.py``.

The jitted table is called directly (no gate) inside
``jax.enable_x64(True)``: the kernels are float64 programs, and without
x64 JAX runs them in float32, which is not the numpy lane they are the
device twins of.  XLA on the CPU also treats subnormal doubles as
signed zeros (inputs and results); numpy and the card do not, and the
port follows numpy — the lane dbeel_tpu serves from.  So the port is
held bit-equal to numpy on the data as it is, and bit-equal to the
jitted table on the same data with subnormals flushed (``_daz``).

Tolerances: masks and min/max are compared bit for bit; a sum may
differ from ``math.fsum`` of the masked values by at most
``n * 2**-52 * sum(|x|)`` (any summation order of n doubles stays within
it)."""

import json
import math
import random
import struct

import jax
import msgpack
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from dbeel_tpu import query as JQ
from dbeel_tpu.ops import query_kernels as jqk
from dbeel_tpu_torch import query as TQ
from dbeel_tpu_torch.errors import BadFieldType
from dbeel_tpu_torch.ops import _cuda
from dbeel_tpu_torch.ops import query_kernels as tqk
from dbeel_tpu_torch.utils import msgpack_codec as C

OPS = ("==", "!=", "<", "<=", ">", ">=")
SUB = 5e-324  # the smallest subnormal
ODD = [0.0, -0.0, 0.25, -0.25, float("inf"), -float("inf"), float("nan"),
       SUB, -SUB, 2.2250738585072014e-308, 1e308, -1e308]


def _column(seed, n):
    """Seeded values salted with every IEEE edge (NaN, +-inf, +-0.0,
    subnormals, exact ties to the operands) and a 20%-invalid mask."""
    rng = np.random.default_rng(seed)
    vals = rng.normal(size=n) * rng.choice([1e-3, 1.0, 1e6], size=n)
    pick = rng.random(n) < 0.3
    vals[pick] = rng.choice(ODD, size=int(pick.sum()))
    valid = rng.random(n) >= 0.2
    return vals, valid


def _daz(x):
    """``x`` with subnormals flushed to zeros of their sign, as XLA's
    CPU backend reads and writes them."""
    x = np.asarray(x, dtype=np.float64)
    return np.where(np.abs(x) < np.finfo(np.float64).tiny,
                    np.copysign(0.0, x), x)


def _bits(x):
    return np.asarray(x, dtype=np.float64).view(np.int64)


def _jax(name, *args, **kw):
    with jax.enable_x64(True):
        out = jqk._kernels()[name](*args, **kw)
        if isinstance(out, tuple):
            return tuple(np.asarray(o) for o in out)
        return np.asarray(out)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ----------------------------------------------------------------------
# K8 kernels (plain versions) against dbeel_tpu's jitted table
# ----------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 7, 4096, 8192 + 3])
@pytest.mark.parametrize("operand", ODD + [1.5])
def test_cmp_f64_bit_equal(n, operand):
    vals, valid = _column(n, n)
    for op in OPS:
        got = tqk.cmp_f64(_t(vals), _t(valid), operand, op).numpy()
        host = {"==": np.equal, "!=": np.not_equal, "<": np.less,
                "<=": np.less_equal, ">": np.greater,
                ">=": np.greater_equal}[op](vals, operand) & valid
        assert got.dtype == np.bool_ and np.array_equal(got, host), op
        want = _jax("cmp", vals, valid, operand, op)
        flushed = tqk.cmp_f64(
            _t(_daz(vals)), _t(valid), float(_daz(operand)), op
        ).numpy()
        assert np.array_equal(flushed, want), op


@pytest.mark.parametrize("n", [3, 4096, 10000])
def test_range_f64_bit_equal(n):
    vals, valid = _column(100 + n, n)
    bounds = [(-0.25, 0.25), (0.0, -0.0), (-0.0, 0.0), (-float("inf"), SUB),
              (0.25, float("inf")), (float("nan"), 1.0), (-1.0, 1e6)]
    for lo, hi in bounds:
        for use_lo, use_hi in ((True, False), (False, True), (True, True),
                               (False, False)):
            got = tqk.range_f64(
                _t(vals), _t(valid), lo, hi, use_lo, use_hi
            ).numpy()
            host = valid.copy()
            if use_lo:
                host &= vals >= lo
            if use_hi:
                host &= vals < hi
            assert np.array_equal(got, host), (lo, hi, use_lo, use_hi)
            want = _jax("range", vals, valid, lo, hi, use_lo, use_hi)
            flushed = tqk.range_f64(
                _t(_daz(vals)), _t(valid), float(_daz(lo)),
                float(_daz(hi)), use_lo, use_hi,
            ).numpy()
            assert np.array_equal(flushed, want), (lo, hi, use_lo, use_hi)


def _masks(vals, valid, rng):
    n = vals.size
    finite = np.isfinite(vals)
    zero = vals == 0
    return {
        "valid": valid,
        "empty": np.zeros(n, bool),
        "all": np.ones(n, bool),
        "finite": valid & finite,
        "zeros": zero,
        "neg_zero_only": zero & np.signbit(vals),
        "pos_zero_only": zero & ~np.signbit(vals),
        "random": rng.random(n) < 0.5,
    }


@pytest.mark.parametrize("n", [1, 5, 4096, 9001])
def test_min_max_f64_bit_equal_nan_and_empty(n):
    vals, valid = _column(200 + n, n)
    vals[0] = -0.0
    for name, mask in _masks(vals, valid, np.random.default_rng(n)).items():
        got = tqk.min_max_f64(_t(vals), _t(mask))
        sel = vals[mask]
        if sel.size == 0:
            host = (math.inf, -math.inf)
        elif np.isnan(sel).any():
            host = (math.nan, math.nan)
        else:
            # numpy's min/max with XLA's order of zeros (-0.0 < 0.0).
            host = [sel.min(), sel.max()]
            if host[0] == 0:
                host[0] = -0.0 if np.signbit(sel[sel == 0]).any() else 0.0
            if host[1] == 0:
                host[1] = 0.0 if (~np.signbit(sel[sel == 0])).any() else -0.0
        for g, h in zip(got, host):
            assert g.dtype == torch.float64 and g.dim() == 0
            assert _bits(g.item()) == _bits(h), (name, g.item(), h)
        want = _jax("min_max", vals, mask)
        flushed = tqk.min_max_f64(_t(_daz(vals)), _t(mask))
        for g, w in zip(flushed, want):
            assert _bits(g.item()) == _bits(w), (name, g.item(), w)


def test_min_max_f64_empty_column():
    mn, mx = tqk.min_max_f64(
        torch.zeros(0, dtype=torch.float64), torch.zeros(0, dtype=torch.bool)
    )
    assert (mn.item(), mx.item()) == (math.inf, -math.inf)


# Lengths just past a K8d chunk boundary: on the card a block reduces
# 4096 rows up to 2^20 rows and 8192 past it (csrc/query.cu
# min_max_chunk); 1025 is past a K8c chunk.
K8D_LENGTHS = (1025, 4097, 8193, 3 * 4096 + 5, (1 << 20) + 1,
               (1 << 20) + 8193)
K8D_CASES = (
    ["two_nans", "one_of_two_nans", "no_nan_masked_in"]
    + [f"{first}{only}" for first in ("neg_zero_first", "pos_zero_first")
       for only in ("", "_zeros_only")]
    + [f"past_boundary_{n}{tail}" for n in K8D_LENGTHS
       for tail in ("", "_tail_only")]
)


def _k8d_cases():
    """K8d's edge columns as (name, vals, mask): two NaNs in one column,
    in two chunks; -0.0 and 0.0 in different chunks, in both orders;
    lengths just past a chunk boundary, with the extremes in the last,
    short chunk."""
    vals, valid = _column(1100, 9000)
    vals[np.isnan(vals)] = 0.5
    two = vals.copy()
    two[[10, 5000]] = float("nan")
    one_in = valid.copy()
    one_in[[10, 5000]] = [True, False]
    yield "two_nans", two, valid | np.isin(np.arange(9000), [10, 5000])
    yield "one_of_two_nans", two, one_in
    yield "no_nan_masked_in", two, one_in & ~np.isnan(two)
    for name, neg, pos in (("neg_zero_first", 5, 8500),
                           ("pos_zero_first", 8500, 5)):
        z = np.full(9000, 7.0)
        z[neg], z[pos] = -0.0, 0.0
        yield name, z, np.ones(9000, bool)
        yield name + "_zeros_only", z, z == 0
    for n in K8D_LENGTHS:
        v, m = _column(1200 + n, n)
        v[np.isnan(v)] = 0.5
        v[-1], m[-1] = -1e300, True
        v[-2], m[-2] = 1e300, True
        yield f"past_boundary_{n}", v, m
        yield f"past_boundary_{n}_tail_only", v, np.arange(n) >= n - 2


def _k8d_case(name):
    return next((v, m) for n, v, m in _k8d_cases() if n == name)


@pytest.mark.parametrize("name", K8D_CASES)
def test_min_max_f64_k8d_edges_equal_reference(name):
    vals, mask = _k8d_case(name)
    got = tqk.min_max_f64(_t(vals), _t(mask))
    sel = vals[mask]
    if np.isnan(sel).any():
        host = (math.nan, math.nan)
    else:
        host = [sel.min(), sel.max()]
        zeros = sel[sel == 0]
        if host[0] == 0:
            host[0] = -0.0 if np.signbit(zeros).any() else 0.0
        if host[1] == 0:
            host[1] = 0.0 if (~np.signbit(zeros)).any() else -0.0
    # The extremes here are not subnormal: XLA's flush changes nothing.
    want = _jax("min_max", vals, mask)
    for g, h, w in zip(got, host, want):
        assert _bits(g.item()) == _bits(h) == _bits(w), (name, g.item(), h, w)


# NaNs of different bits (quiet and signalling payloads, the sign bit
# set), each case as {row: bits} over a 9000-row column with the NaN rows
# masked in, and one case where they are masked out.
K8D_NAN_PAYLOADS = {
    "one_chunk": {10: 0x7FF8000000000001, 20: 0x7FF0000000000ABC},
    "two_chunks": {10: 0x7FF8000000000001, 5000: 0x7FFFFFFFFFFFFFFF},
    "signs_differ": {10: 0xFFF8000000000123, 5000: 0x7FF8000000000002},
    "sign_set_only": {10: 0xFFF8000000000123, 8999: 0xFFF0000000000001},
    "masked_out": {10: 0x7FF8000000000001, 5000: 0xFFF8000000000123},
}


def _k8d_nan_case(name):
    vals, valid = _column(1500, 9000)
    vals[np.isnan(vals)] = 0.5
    rows = list(K8D_NAN_PAYLOADS[name])
    vals.view(np.uint64)[rows] = list(K8D_NAN_PAYLOADS[name].values())
    valid[rows] = name != "masked_out"
    return vals, valid


@pytest.mark.parametrize("name", sorted(K8D_NAN_PAYLOADS))
def test_min_max_f64_nan_payloads(name):
    """Masked-in NaNs of different bits make both results NaN (their
    bits are not specified); masked out, they change no bit."""
    vals, mask = _k8d_nan_case(name)
    got = [x.item() for x in tqk.min_max_f64(_t(vals), _t(mask))]
    want = _jax("min_max", vals, mask)
    if name == "masked_out":
        for g, w in zip(got, want):
            assert _bits(g) == _bits(w), (name, g, w)
    else:
        assert np.isnan(got).all() and np.isnan(want).all(), (got, want)


@pytest.mark.parametrize("n", [1, 4096, 20000])
def test_sum_f64_within_bound(n):
    vals, valid = _column(300 + n, n)
    # Sums of several +-1e308 overflow, and math.fsum has no exact
    # value to hold them to: those rows become 1.0 here.
    vals[np.abs(vals) == 1e308] = 1.0
    for name, mask in _masks(vals, valid, np.random.default_rng(n)).items():
        masked = vals[mask]
        got = tqk.sum_f64(_t(vals), _t(mask)).item()
        want = float(_jax("sum", vals, mask))
        if not np.isfinite(masked).all():
            # NaN or inf among the summed rows: both sides agree on the
            # non-finite result.
            assert _bits(got) == _bits(want) or (
                math.isnan(got) and math.isnan(want)
            ), name
            continue
        exact = math.fsum(masked.tolist())
        bound = n * 2.0**-52 * float(np.abs(masked).sum())
        assert abs(got - exact) <= bound, (name, got, exact)
        flushed = _daz(masked)
        assert abs(want - math.fsum(flushed.tolist())) <= (
            n * 2.0**-52 * float(np.abs(flushed).sum())
        ), (name, want)


# Odd lengths (the vector kernels' tails) and views that start 1-15
# elements into the values and the mask (off the 16 B / 4 B boundaries
# of K8a's and K8c's vector loads), with the two offsets different.
ODD_LENGTHS = [1, 3, 1023, 1025, 4097, (1 << 20) + 3]
OFFSETS = [(o, (7 * o + 3) % 16) for o in range(16)]
SALTS = [0.25, -0.0, float("nan"), float("inf"), SUB]


def _views(seed, n):
    """A salted column of n + 15 rows, and its (values, mask) views of
    n rows at every pair of OFFSETS, as torch views with those storage
    offsets and as numpy arrays."""
    vals, valid = _column(seed, n + 15)
    tv, tm = _t(vals), _t(valid)
    for ov, om in OFFSETS:
        yield ((ov, om), tv[ov:ov + n], tm[om:om + n], vals[ov:ov + n],
               valid[om:om + n])


@pytest.mark.parametrize("n", ODD_LENGTHS)
def test_cmp_f64_odd_lengths_and_offsets_equal_reference(n):
    flush_operand = {x: float(_daz(x)) for x in SALTS}
    for where, v, m, vals, valid in _views(500 + n, n):
        assert (v.storage_offset(), m.storage_offset()) == where
        flushed = _t(_daz(vals))
        for op in OPS:
            for x in SALTS + [float(vals[min(7, n - 1)])]:
                got = tqk.cmp_f64(v, m, x, op).numpy()
                host = {"==": np.equal, "!=": np.not_equal, "<": np.less,
                        "<=": np.less_equal, ">": np.greater,
                        ">=": np.greater_equal}[op](vals, x) & valid
                assert np.array_equal(got, host), (where, op, x)
                want = _jax("cmp", vals, valid, x, op)
                got = tqk.cmp_f64(
                    flushed, m, flush_operand.get(x, float(_daz(x))), op
                ).numpy()
                assert np.array_equal(got, want), (where, op, x)


@pytest.mark.parametrize("n", [0] + ODD_LENGTHS)
def test_sum_f64_odd_lengths_and_offsets_equal_reference(n):
    for where, v, m, vals, valid in _views(600 + n, n):
        fin = valid & np.isfinite(vals) & (np.abs(vals) != 1e308)
        mask = _t(fin)
        got = tqk.sum_f64(v, mask).item()
        sel = vals[fin]
        bound = max(n, 1) * 2.0**-52 * float(np.abs(sel).sum())
        assert abs(got - math.fsum(sel.tolist())) <= bound, where
        want = float(_jax("sum", vals, fin))
        flushed = _daz(sel)
        assert abs(want - math.fsum(flushed.tolist())) <= (
            max(n, 1) * 2.0**-52 * float(np.abs(flushed).sum())
        ), where
        # An empty mask (and n = 0) sums to +0.0 on both sides.
        empty = np.zeros(n, bool)
        assert _bits(tqk.sum_f64(v, _t(empty)).item()) == _bits(0.0)
        assert _bits(_jax("sum", vals, empty)) == _bits(0.0)
    if n:
        # A masked-in NaN propagates; the same row masked out does not.
        vals, valid = _column(600 + n, n)
        vals[n // 2] = float("nan")
        nan_at = np.zeros(n, bool)
        nan_at[n // 2] = True
        assert math.isnan(tqk.sum_f64(_t(vals), _t(nan_at)).item())
        assert math.isnan(float(_jax("sum", vals, nan_at)))
        assert not math.isnan(tqk.sum_f64(_t(vals), _t(~nan_at & (
            np.isfinite(vals) & (np.abs(vals) != 1e308)))).item())


def test_kernel_wrappers_refuse_bad_operands():
    v = torch.zeros(8, dtype=torch.float64)
    m = torch.zeros(8, dtype=torch.bool)
    with pytest.raises(ValueError):
        tqk.cmp_f64(v, m, 0.0, "=~")
    with pytest.raises(ValueError):
        tqk.cmp_f64(v.float(), m, 0.0, "<")
    with pytest.raises(ValueError):
        tqk.sum_f64(v, m[:4])
    with pytest.raises(ValueError):
        tqk.min_max_f64(v[::2], m[::2])
    with pytest.raises(ValueError):
        tqk.range_f64(v.reshape(2, 4), m.reshape(2, 4), 0, 1, True, True)


def test_host_entries_size_rule_and_device(monkeypatch):
    vals, valid = _column(7, tqk.MIN_DEVICE_ROWS)
    mask = tqk.eval_cmp_f64(vals, valid, 0.25, "<=", device="cpu")
    assert np.array_equal(mask, (vals <= 0.25) & valid)
    mask = tqk.eval_range_f64(vals, valid, None, 0.25, device="cpu")
    assert np.array_equal(mask, (vals < 0.25) & valid)
    # Below MIN_DEVICE_ROWS the caller's numpy lane serves.
    assert tqk.eval_cmp_f64(vals[:-1], valid[:-1], 0.0, "<", "cpu") is None
    assert tqk.eval_range_f64(vals[:-1], valid[:-1], 0, 1, "cpu") is None
    fin = valid & np.isfinite(vals) & (np.abs(vals) < 1e300)
    assert tqk.eval_min_max_f64(vals, fin, "cpu") == (
        float(vals[fin].min()), float(vals[fin].max())
    )
    exact = math.fsum(vals[fin].tolist())
    assert abs(tqk.eval_sum_f64(vals, fin, "cpu") - exact) <= (
        vals.size * 2.0**-52 * float(np.abs(vals[fin]).sum())
    )
    # No card and no device="cpu": the entry raises, no numpy fallback.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tqk.eval_cmp_f64(vals, valid, 0.0, "<")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tqk.eval_range_f64(vals, valid, 0.0, None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tqk.eval_sum_f64(vals, valid)


def test_persist_wake_records_first_card_launch_only(tmp_path, monkeypatch):
    path = tmp_path / "last_good.json"
    monkeypatch.setenv("DBEEL_DEVICE_LAST_GOOD", str(path))
    monkeypatch.setattr(tqk, "_persisted", set())
    assert tqk.last_good_path() == str(path)
    # Plain versions never write it.
    tqk.eval_cmp_f64(*_column(1, 5000), 0.0, "<", device="cpu")
    tqk._persist_wake(torch.device("cpu"), "query_filter", rows=1)
    assert not path.exists()
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "Card")
    tqk._persist_wake(torch.device("cuda"), "query_filter", rows=5000,
                      kernels="K8a cmp_f64")
    tqk._persist_wake(torch.device("cuda"), "query_filter", rows=9)
    tqk._persist_wake(torch.device("cuda"), "coalesced_compaction",
                      batch_jobs=8, k=4, p=1 << 17)
    data = json.loads(path.read_text())
    assert data["query_filter"]["platform"] == "gpu"
    assert data["query_filter"]["device"] == "Card"
    assert data["query_filter"]["rows"] == 5000
    assert data["coalesced_compaction"]["batch_jobs"] == 8
    monkeypatch.delenv("DBEEL_DEVICE_LAST_GOOD")
    assert tqk.last_good_path().startswith(_cuda.BUILD_DIR)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 255, 4096, 1 << 20])
def test_cuda_k8_equals_plain(cuda_device, n):
    vals, valid = _column(400 + n, n)
    v, m = _t(vals).to(cuda_device), _t(valid).to(cuda_device)
    for op in OPS:
        for x in (0.25, -0.0, float("nan"), float("inf")):
            assert torch.equal(
                tqk.cmp_f64(v, m, x, op), tqk.cmp_f64_plain(v, m, x, op)
            )
    for use_lo, use_hi in ((True, False), (False, True), (True, True)):
        assert torch.equal(
            tqk.range_f64(v, m, -0.25, 0.25, use_lo, use_hi),
            tqk.range_f64_plain(v, m, -0.25, 0.25, use_lo, use_hi),
        )
    # The sum's column without +-1e308 (math.fsum overflows on them).
    sums = np.where(np.abs(vals) == 1e308, 1.0, vals)
    s = _t(sums).to(cuda_device)
    for name, mask in _masks(vals, valid, np.random.default_rng(n)).items():
        mk = _t(mask).to(cuda_device)
        for g, w in zip(tqk.min_max_f64(v, mk), tqk.min_max_f64_plain(v, mk)):
            assert _bits(g.item()) == _bits(w.item()), name
        masked = sums[mask]
        got = tqk.sum_f64(s, mk).item()
        if np.isfinite(masked).all():
            bound = max(n, 1) * 2.0**-52 * float(np.abs(masked).sum())
            assert abs(got - math.fsum(masked.tolist())) <= bound, name
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("n", ODD_LENGTHS)
def test_cuda_k8a_odd_lengths_and_misaligned_views(cuda_device, n):
    vals, valid = _column(700 + n, n + 15)
    tv, tm = _t(vals).to(cuda_device), _t(valid).to(cuda_device)
    for ov, om in OFFSETS:
        v, m = tv[ov:ov + n], tm[om:om + n]
        assert v.data_ptr() % 16 == (ov % 2) * 8
        for op in OPS:
            for x in ODD + [1.5, float(vals[ov + min(7, n - 1)])]:
                assert torch.equal(
                    tqk.cmp_f64(v, m, x, op), tqk.cmp_f64_plain(v, m, x, op)
                ), (ov, om, op, x)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0] + ODD_LENGTHS)
def test_cuda_k8c_odd_lengths_and_misaligned_views(cuda_device, n):
    vals, valid = _column(800 + n, n + 15)
    vals[np.abs(vals) == 1e308] = 1.0  # math.fsum overflows on them
    tv, tm = _t(vals).to(cuda_device), _t(valid).to(cuda_device)
    fin_all = torch.isfinite(tv)
    for ov, om in OFFSETS:
        v = tv[ov:ov + n]
        m = tm[om:om + n] & fin_all[ov:ov + n]
        got = tqk.sum_f64(v, m).item()
        sel = vals[ov:ov + n][m.cpu().numpy()]
        bound = max(n, 1) * 2.0**-52 * float(np.abs(sel).sum())
        assert abs(got - math.fsum(sel.tolist())) <= bound, (ov, om)
        # The vector and the scalar path add in one order: a misaligned
        # view sums to the bits of its aligned copy.
        assert _bits(tqk.sum_f64(v.clone(), m.clone()).item()) == _bits(got)
        assert _bits(tqk.sum_f64(v, torch.zeros_like(m)).item()) == _bits(0.0)
        if n:
            nan_in = m.clone()
            nan_in[n // 2] = True
            v_nan = v.clone()
            v_nan[n // 2] = float("nan")
            assert math.isnan(tqk.sum_f64(v_nan, nan_in).item())
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_k8c_bit_identical_repeated_and_on_two_streams(cuda_device):
    import threading

    n = 1_000_000
    vals, valid = _column(900, n)
    v = _t(vals).to(cuda_device)
    m = _t(valid).to(cuda_device) & torch.isfinite(v)
    want = _bits(tqk.sum_f64(v, m).item())
    assert all(_bits(tqk.sum_f64(v, m).item()) == want for _ in range(20))
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(cuda_device) for _ in range(2)]
    got, errors = [None, None], []

    def run(i):
        try:
            with torch.cuda.stream(streams[i]):
                outs = [tqk.sum_f64(v, m) for _ in range(50)]
            streams[i].synchronize()
            got[i] = [_bits(o.item()) for o in outs]
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert all(g == [want] * 50 for g in got)
    # Each stream had a scratch (and a ticket) of its own.
    keys = {(cuda_device.index or 0, s.cuda_stream) for s in streams}
    assert keys <= set(tqk._sum_scratch)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0] + ODD_LENGTHS)
def test_cuda_k8d_odd_lengths_and_misaligned_views(cuda_device, n):
    """One launch at every length and alignment: bit-equal to the plain
    version (NaN, -0.0 and an empty mask included) and to the view's
    aligned copy."""
    vals, valid = _column(1300 + n, n + 15)
    tv, tm = _t(vals).to(cuda_device), _t(valid).to(cuda_device)
    zero = tv == 0
    for ov, om in OFFSETS:
        v = tv[ov:ov + n]
        for m in (tm[om:om + n], torch.zeros_like(tm[om:om + n]),
                  zero[om:om + n] & tm[om:om + n],
                  tm[om:om + n] & ~torch.isnan(v)):
            got = tqk.min_max_f64(v, m)
            for g, w in zip(got, tqk.min_max_f64_plain(v, m)):
                assert _bits(g.item()) == _bits(w.item()), (ov, om)
            for g, w in zip(got, tqk.min_max_f64(v.clone(), m.clone())):
                assert _bits(g.item()) == _bits(w.item()), (ov, om)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("name", K8D_CASES)
def test_cuda_k8d_edges_equal_plain(cuda_device, name):
    vals, mask = _k8d_case(name)
    v, m = _t(vals).to(cuda_device), _t(mask).to(cuda_device)
    before = _cuda.launches["K8d"]
    got = tqk.min_max_f64(v, m)
    assert _cuda.launches["K8d"] == before + 1
    for g, w in zip(got, tqk.min_max_f64_plain(v, m)):
        assert _bits(g.item()) == _bits(w.item()), name


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(K8D_NAN_PAYLOADS))
def test_cuda_k8d_nan_payloads(cuda_device, name):
    """The kernel returns one of the masked-in NaNs, the same on every
    call, where the plain version returns a NaN; masked out, they change
    no bit."""
    vals, mask = _k8d_nan_case(name)
    v, m = _t(vals).to(cuda_device), _t(mask).to(cuda_device)
    got = [_bits(x.item()) for x in tqk.min_max_f64(v, m)]
    plain = [x.item() for x in tqk.min_max_f64_plain(v, m)]
    if name == "masked_out":
        assert got == [_bits(x) for x in plain], name
        return
    nans = {int(_bits(vals[r])) for r in K8D_NAN_PAYLOADS[name]}
    assert got[0] == got[1] and int(got[0]) in nans, (name, got)
    assert np.isnan(plain).all(), plain
    for _ in range(5):
        assert [_bits(x.item()) for x in tqk.min_max_f64(v, m)] == got


@pytest.mark.cuda
def test_cuda_k8d_bit_identical_repeated_and_on_two_streams(cuda_device):
    import threading

    n = 1_000_000
    vals, valid = _column(1400, n)
    v, m = _t(vals).to(cuda_device), _t(valid).to(cuda_device)
    fin = m & ~torch.isnan(v)
    want = [[_bits(x.item()) for x in tqk.min_max_f64(v, mk)]
            for mk in (m, fin)]
    assert all([_bits(x.item()) for x in tqk.min_max_f64(v, fin)] == want[1]
               for _ in range(20))
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(cuda_device) for _ in range(2)]
    got, errors = [None, None], []

    def run(i):
        try:
            with torch.cuda.stream(streams[i]):
                outs = [tqk.min_max_f64(v, (m, fin)[j % 2]) for j in range(50)]
            streams[i].synchronize()
            got[i] = [[_bits(x.item()) for x in o] for o in outs]
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert all(g == [want[j % 2] for j in range(50)] for g in got)
    keys = {(cuda_device.index or 0, s.cuda_stream) for s in streams}
    assert keys <= set(tqk._min_max_scratch)


# ----------------------------------------------------------------------
# The MessagePack codec against the msgpack package
# ----------------------------------------------------------------------

_scalars = (
    st.none() | st.booleans()
    | st.integers(min_value=-(1 << 63), max_value=(1 << 64) - 1)
    | st.floats(allow_nan=False) | st.text() | st.binary()
)
_docs = st.recursive(
    _scalars,
    lambda kids: st.lists(kids, max_size=20)
    | st.dictionaries(st.text() | st.binary(), kids, max_size=20),
    max_leaves=60,
)


def _outcome(fn, raw):
    """("ok", re-packed bytes) or ("err",): results compared through
    msgpack's own packer (NaN-safe, ext- and Timestamp-aware)."""
    try:
        obj = fn(raw)
    except ValueError:
        return ("err",)
    return ("ok", msgpack.packb(_to_msgpack(obj), use_bin_type=True))


def _to_msgpack(obj):
    if isinstance(obj, C.ExtType):
        return msgpack.ExtType(obj.code, obj.data)
    if isinstance(obj, C.Timestamp):
        return msgpack.Timestamp(obj.seconds, obj.nanoseconds)
    if isinstance(obj, list):
        return [_to_msgpack(x) for x in obj]
    if isinstance(obj, dict):
        return {k: _to_msgpack(v) for k, v in obj.items()}
    return obj


@settings(max_examples=300, deadline=None, database=None)
@given(_docs)
def test_codec_round_trip_matches_msgpack(obj):
    blob = msgpack.packb(obj, use_bin_type=True)
    assert C.packb(obj) == blob
    assert _outcome(C.unpackb, blob) == _outcome(
        lambda b: msgpack.unpackb(b, raw=False), blob
    )


@settings(max_examples=500, deadline=None, database=None)
@given(st.binary(max_size=40))
def test_codec_raises_where_msgpack_raises(raw):
    assert _outcome(C.unpackb, raw) == _outcome(
        lambda b: msgpack.unpackb(b, raw=False), raw
    )


@pytest.mark.parametrize("raw", [
    b"\xa2\xc3\x28",  # a str that is not UTF-8
    b"\xd9\x01\xff",
    b"\x81\x01\x02",  # {1: 2}: int map key (strict_map_key)
    b"\x81\xc0\x01", b"\x81\xc3\x01", b"\x81\x91\x01\x01",
    b"\x01\x02",  # trailing bytes
    b"\x92\x01",  # truncated
    b"\xc1", b"",
    b"\xd6\xff\x00\x00\x00\x01",  # timestamp ext -1
    b"\xd5\xff\x00\x01",  # timestamp of a bad length
    b"\xd4\x80\x00",  # negative ext code other than -1
    b"\xc7\x03\x05abc", b"\xca\x3f\xc0\x00\x00",  # ext, float32
    b"\x91" * 400 + b"\x01",
], ids=lambda raw: raw[:12].hex())
def test_codec_malformed_and_edge_inputs(raw):
    assert _outcome(C.unpackb, raw) == _outcome(
        lambda b: msgpack.unpackb(b, raw=False), raw
    )


def test_codec_packs_like_msgpack_at_type_edges():
    objs = [0, 127, 128, 255, 256, 65535, 65536, (1 << 32) - 1, 1 << 32,
            (1 << 64) - 1, -1, -32, -33, -128, -129, -32768, -32769,
            -(1 << 31), -(1 << 31) - 1, -(1 << 63), 1.5, float("nan"),
            -0.0, "a" * 31, "a" * 32, "a" * 255, "a" * 256, "é" * 40000,
            b"x" * 255, b"x" * 256, b"x" * 70000, bytearray(b"ab"),
            memoryview(b"cd"), (1, 2), [1] * 16, [1] * 70000,
            {str(i): i for i in range(16)}, {1: 2}, True, None]
    for obj in objs:
        assert C.packb(obj) == msgpack.packb(obj, use_bin_type=True)
    assert C.packb(C.ExtType(5, b"abc")) == msgpack.packb(
        msgpack.ExtType(5, b"abc"))
    for bad in (1 << 64, -(1 << 63) - 1):
        with pytest.raises(OverflowError):
            C.packb(bad)
    for bad in ({1, 2}, object(), "\ud800"):
        with pytest.raises((TypeError, ValueError)):
            msgpack.packb(bad, use_bin_type=True)
        with pytest.raises((TypeError, ValueError)):
            C.packb(bad)


# ----------------------------------------------------------------------
# query.py: the golden evaluator and the aggregate states
# ----------------------------------------------------------------------


def _doc(rng, i):
    """The adversarial document mix of tests/test_scan_plane.py."""
    roll = rng.random()
    if roll < 0.05:
        return i
    doc = {}
    if rng.random() < 0.9:
        doc["n"] = rng.choice([
            rng.randrange(-50, 50), float(rng.randrange(-500, 500)) / 7.0,
            (1 << 54) + rng.randrange(100), -((1 << 55) + rng.randrange(100)),
            True, float("nan"),
        ])
    if rng.random() < 0.85:
        doc["s"] = rng.choice(["apple", "banana", "cherry" * 2,
                               b"raw\x00middle", b"trailing\x00",
                               b"x" * 300, ""])
    if rng.random() < 0.3:
        doc["weird"] = [1, 2, 3]
    doc["i"] = i
    return doc


def _where(rng):
    def leaf():
        field = rng.choice(["$key", "n", "s", "i", "missing"])
        kind = rng.choice(["cmp", "prefix", "range"])
        if field == "$key":
            a, b = sorted(msgpack.packb(f"k{rng.randrange(300):04d}")
                          for _ in range(2))
            return {"cmp": ["cmp", field, rng.choice(OPS), a],
                    "prefix": ["prefix", field, a[:rng.randrange(1, 5)]],
                    "range": ["range", field, a, b]}[kind]
        if kind == "cmp":
            return ["cmp", field, rng.choice(OPS), rng.choice([
                rng.randrange(-60, 60), float(rng.randrange(-70, 70)) / 3,
                (1 << 54) + 5, "banana", b"raw\x00middle", b"k0001"])]
        if kind == "prefix":
            return ["prefix", field, rng.choice([b"app", b"\xa6k0", b""])]
        if rng.random() < 0.5:
            return ["range", field, *sorted(
                [rng.randrange(-60, 60), rng.randrange(-60, 60)])]
        return ["range", field, b"a", rng.choice([b"cherry", b"z"])]

    def tree(depth):
        if depth == 0 or rng.random() < 0.4:
            return leaf()
        return [rng.choice(["and", "or"]),
                *[tree(depth - 1) for _ in range(rng.randrange(1, 4))]]

    return tree(2)


def test_golden_evaluator_equals_reference():
    rng = random.Random(31)
    rows = [(msgpack.packb(f"k{i:04d}"), msgpack.packb(_doc(rng, i)))
            for i in range(300)]
    rows += [(b"\xa5k9999", b""), (b"\xa5k9998", b"\xc1"),
             (b"\xa5k9997", msgpack.packb({1: 2})),
             (b"\xa5k9996", msgpack.packb({"n": msgpack.ExtType(1, b"x")})),
             (b"\xa5k9995", b"\xd6\xff\x00\x00\x00\x01")]
    for _ in range(60):
        raw = _where(rng)
        jw, tw = JQ.validate_where(raw), TQ.validate_where(raw)
        assert jw == tw
        for key, value in rows:
            assert JQ.match_entry(jw, key, value) == TQ.match_entry(
                tw, key, value)
    for key, value in rows:
        jd, td = JQ.decode_doc(value), TQ.decode_doc(value)
        assert (jd is None) == (td is None)
        for f in ("n", "s", "i", "weird"):
            a, b = JQ.field_value(jd, f), TQ.field_value(td, f)
            assert repr(a) == repr(b), (key, f)
    assert TQ.decode_doc(msgpack.packb({1: 2})) is None


def test_spec_packing_and_aggregates_equal_reference():
    rng = random.Random(5)
    for _ in range(40):
        raw = _where(rng)
        agg = {"op": rng.choice(JQ.AGG_OPS), "field": "n",
               "group": rng.choice([0, 3])}
        spec = TQ.pack_spec(*TQ.build_spec(raw, agg))
        assert spec == JQ.pack_spec(*JQ.build_spec(raw, agg))
        assert TQ.unpack_spec(spec) == JQ.unpack_spec(spec)
        peer = TQ.pack_peer_spec(*TQ.build_spec(raw, agg), TQ.MODE_MARK)
        assert peer == JQ.pack_peer_spec(*JQ.build_spec(raw, agg), "mark")
        assert TQ.unpack_peer_spec(peer) == JQ.unpack_peer_spec(peer)
        assert TQ.spec_fields(*TQ.build_spec(raw, agg)) == JQ.spec_fields(
            *JQ.build_spec(raw, agg))
    for bad in (b"\xc1", msgpack.packb(["q0", None, None]), 7,
                msgpack.packb(["q1", ["cmp", "n", "=~", 1], None])):
        with pytest.raises(BadFieldType):
            TQ.unpack_spec(bad)
    values = [rng.choice([rng.randrange(-9, 9), rng.random() * 1e6, 0.1,
                          -0.0, 1 << 70, "x", None]) for _ in range(400)]
    for op in JQ.AGG_OPS:
        js, ts = JQ.AggState({"op": op, "field": "n", "group": 2}), \
            TQ.AggState({"op": op, "field": "n", "group": 2})
        for i, x in enumerate(values):
            key = b"g%d-%d" % (i % 3, i)
            js.fold_row(key, x)
            ts.fold_row(key, x)
        assert repr(js.result()) == repr(ts.result())
        assert js.to_wire() == ts.to_wire()
        back = TQ.AggState.from_wire(ts.agg, ts.to_wire())
        assert repr(back.result()) == repr(ts.result())
    partials = []
    for x in (1e16, 1.0, -1e16, 3.5, 0.1):
        TQ.grow_partials(partials, x)
    assert math.fsum(partials) == math.fsum([1e16, 1.0, -1e16, 3.5, 0.1])
    assert TQ.increment_prefix(b"ab\xff") == b"ac"
    assert TQ.increment_prefix(b"\xff\xff") is None
    assert struct.pack(">d", TQ.agg_result([2, 3, [0.5], None, None],
                                           "avg")) == struct.pack(">d", 1.75)
