"""The leaf planes of dbeel_tpu_torch's server against dbeel_tpu: the
share scheduler and its intra-merge throttle, the metrics hub, the
flight recorder, the QoS plane, the load governor, the hint log and
the telemetry plane.  Both packages read one injected clock (each
module's ``time`` is replaced by the same fake), take the same seeded
event streams, and must agree exactly; the hint logs they write must
be SHA-256-equal."""

import asyncio
import hashlib
import itertools
import os
from collections import deque
from types import SimpleNamespace

import numpy as np
import pytest

from conftest import run, write_sstable_fixture

from dbeel_tpu import config as jconfig
from dbeel_tpu import errors as jerrors
from dbeel_tpu.cluster import messages as jmsgs
from dbeel_tpu.server import governor as jgov
from dbeel_tpu.server import hints as jhints
from dbeel_tpu.server import metrics as jmetrics
from dbeel_tpu.server import qos as jqos
from dbeel_tpu.server import scheduler as jsched
from dbeel_tpu.server import telemetry as jtele
from dbeel_tpu.server import trace as jtrace
from dbeel_tpu_torch import config as tconfig
from dbeel_tpu_torch import errors as terrors
from dbeel_tpu_torch.cluster import messages as tmsgs
from dbeel_tpu_torch.server import governor as tgov
from dbeel_tpu_torch.server import hints as thints
from dbeel_tpu_torch.server import metrics as tmetrics
from dbeel_tpu_torch.server import qos as tqos
from dbeel_tpu_torch.server import scheduler as tsched
from dbeel_tpu_torch.server import telemetry as ttele
from dbeel_tpu_torch.server import trace as ttrace

PKGS = {
    "ref": SimpleNamespace(
        config=jconfig, errors=jerrors, governor=jgov, hints=jhints,
        metrics=jmetrics, msgs=jmsgs, qos=jqos, sched=jsched, tele=jtele,
        trace=jtrace),
    "port": SimpleNamespace(
        config=tconfig, errors=terrors, governor=tgov, hints=thints,
        metrics=tmetrics, msgs=tmsgs, qos=tqos, sched=tsched, tele=ttele,
        trace=ttrace),
}
_TIMED = ("governor", "hints", "metrics", "qos", "sched", "tele", "trace")


class Clock:
    """The injected ``time``: ``monotonic`` advances ``step`` a read,
    ``sleep`` advances the clock instead of waiting, ``time`` is the
    wall clock at a fixed offset."""

    def __init__(self, step=0.0, t0=1000.0):
        self.t = t0
        self.step = step

    def monotonic(self):
        self.t += self.step
        return self.t

    perf_counter = monotonic

    def time(self):
        return 1.7e9 + self.t

    def sleep(self, dt):
        self.t += max(0.0, dt)


class AsyncioShim:
    """The scheduler's ``asyncio``: a sleep on the injected clock."""

    def __init__(self, clock):
        self.clock = clock

    async def sleep(self, dt):
        self.clock.sleep(dt)
        await _real_sleep(0)


_real_sleep = asyncio.sleep


@pytest.fixture
def clocked(monkeypatch):
    """``clocked(pkg, step)`` -> (modules, clock): a fresh clock behind
    every timed module of one package."""

    def make(pkg, step=0.0):
        clock = Clock(step)
        mods = PKGS[pkg]
        for name in _TIMED:
            monkeypatch.setattr(getattr(mods, name), "time", clock)
        monkeypatch.setattr(mods.sched, "asyncio", AsyncioShim(clock))
        return mods, clock

    return make


def _both(clocked, scenario, step=0.0):
    """Run ``scenario(mods, clock)`` on each package under its own
    fresh clock; the results must be equal."""
    got = {pkg: scenario(*clocked(pkg, step)) for pkg in ("ref", "port")}
    assert got["port"] == got["ref"]
    return got["port"]


# ---------------------------------------------------------------------
# scheduler: tests/test_bg_throttle.py's cases on the injected clock
# ---------------------------------------------------------------------


def test_throttle_idle_shard_pays_nothing(clocked):
    def scenario(m, clock):
        s = m.sched.ShareScheduler(1000, 250)
        t = s.thread_throttle()
        t._last = clock.monotonic() - 0.2
        before = clock.monotonic()
        t.tick()
        slept = clock.monotonic() - before
        assert slept < 0.05 and s.bg_throttled_s == 0.0
        return slept, s.stats()

    assert _both(clocked, scenario)[1]["background_precharged_s"] == 0.2


def test_throttle_busy_shard_pays_share_ratio(clocked):
    def scenario(m, clock):
        s = m.sched.ShareScheduler(1000, 500)
        t = s.thread_throttle()
        s.fg_mark()
        s.fg_busy = lambda: True
        t._last = clock.monotonic() - 0.1
        before = clock.monotonic()
        t.tick()
        slept = clock.monotonic() - before
        assert 0.15 <= slept <= 0.6 and s.bg_throttled_s > 0.1
        return round(slept, 9), s.stats()

    assert _both(clocked, scenario)[1]["background_throttled_s"] == 0.2


def test_sparse_cadence_still_throttles(clocked):
    def scenario(m, clock):
        s = m.sched.ShareScheduler(1000, 1000)
        for _ in range(4):
            s.fg_mark()
            clock.sleep(0.2)
        s.fg_mark()
        clock.sleep(0.15)
        assert s.fg_busy(), "200ms cadence must read as busy mid-gap"
        t = s.thread_throttle()
        t._last = clock.monotonic() - 0.1
        before = clock.monotonic()
        t.tick()
        slept = clock.monotonic() - before
        assert slept >= 0.04 and s.bg_throttled_s > 0.0
        return round(slept, 9), s._fg_gap_ewma, s.stats()

    _both(clocked, scenario)


def test_cadence_window_expires_when_traffic_stops(clocked):
    def scenario(m, clock):
        s = m.sched.ShareScheduler()
        for _ in range(3):
            s.fg_mark()
            clock.sleep(0.2)
        s.fg_mark()
        window = min(2.0 * s._fg_gap_ewma, s.FG_MAX_WINDOW_S)
        busy_inside = s.fg_busy()
        clock.sleep(window + 0.25)
        assert busy_inside and not s.fg_busy()
        return window, s.stats()

    _both(clocked, scenario)


def test_throttle_quantum_clamp(clocked):
    def scenario(m, clock):
        s = m.sched.ShareScheduler(1000, 250)
        t = s.thread_throttle()
        s.fg_busy = lambda: True
        t._last = clock.monotonic() - 10.0
        before = clock.monotonic()
        t.tick()
        slept = clock.monotonic() - before
        assert slept <= m.sched.BgThrottle.MAX_QUANTUM_S * 4 + 0.5
        return round(slept, 9), s.stats()

    assert _both(clocked, scenario)[1]["background_precharged_s"] == 0.5


def test_strategy_tick_plumbing():
    from dbeel_tpu_torch.storage.compaction import HeapMergeStrategy

    s = HeapMergeStrategy()
    assert s.throttle is None
    s._tick()
    calls = []

    class FakeThrottle:
        def tick(self):
            calls.append(1)

    s.throttle = FakeThrottle()
    s._tick()
    assert calls == [1]


def _native_lib():
    from dbeel_tpu_torch.storage import native

    lib = native.load()
    if lib is None:
        pytest.skip("native library cannot be built")
    return native, lib


def test_native_merge_cb_ticks_and_matches():
    """dbeel_merge_cb through the port's binding: identical to
    dbeel_merge, the tick callback at the configured stride, and the
    same bytes as the reference's binding of the library."""
    import ctypes

    from dbeel_tpu.storage import native as jnative
    from dbeel_tpu.storage.entry import encode_entry

    native, lib = _native_lib()
    rng = np.random.default_rng(5)

    def build_run(keys):
        recs = [encode_entry(k, b"v" + k, int(rng.integers(1, 1 << 40)))
                for k in keys]
        index, off = b"", 0
        for k, r in zip(keys, recs):
            index += (off.to_bytes(8, "little")
                      + len(k).to_bytes(4, "little")
                      + len(r).to_bytes(4, "little"))
            off += len(r)
        return b"".join(recs), index, len(keys)

    runs = [build_run([b"k%06d" % i for i in range(0, 60000, 2)]),
            build_run([b"k%06d" % i for i in range(1, 60000, 2)])]
    total = sum(len(r[0]) for r in runs)
    n_total = sum(r[2] for r in runs)

    def run_merge(mod, library, use_cb):
        out_data = np.zeros(total, dtype=np.uint8)
        out_index = np.zeros(n_total * 16, dtype=np.uint8)
        out_size = ctypes.c_uint64(0)
        u8 = ctypes.POINTER(ctypes.c_uint8)
        args = (
            (ctypes.c_char_p * 2)(*[r[0] for r in runs]),
            (ctypes.c_char_p * 2)(*[r[1] for r in runs]),
            (ctypes.c_uint64 * 2)(*[r[2] for r in runs]),
            2, 1, out_data.ctypes.data_as(u8), ctypes.byref(out_size),
            out_index.ctypes.data_as(u8),
        )
        ticks = []
        if use_cb:
            cb = mod.TICK_FN(lambda: ticks.append(1))
            n = library.dbeel_merge_cb(*args, cb, 4096)
        else:
            n = library.dbeel_merge(*args)
        return (n, out_data[: out_size.value].tobytes(),
                out_index[: n * 16].tobytes(), len(ticks))

    n0, d0, i0, _ = run_merge(native, lib, False)
    n1, d1, i1, n_ticks = run_merge(native, lib, True)
    assert (n0, d0, i0) == (n1, d1, i1)
    assert n_ticks == n_total // 4096
    jlib = jnative._load()
    if jlib is not None:
        assert run_merge(jnative, jlib, True) == (n1, d1, i1, n_ticks)


def _native_merge(native, tmp_dir, out_index, throttle):
    from dbeel_tpu_torch.storage.sstable import SSTable

    s = native.NativeMergeStrategy()
    s.throttle = throttle
    sources = [SSTable(tmp_dir, 0, None), SSTable(tmp_dir, 2, None)]
    try:
        return s.merge(sources, tmp_dir, out_index, None, True, 1 << 30)
    finally:
        for t in sources:
            t.close()


def _file(tmp_dir, index, ext):
    from dbeel_tpu_torch.storage.entry import file_name

    with open(f"{tmp_dir}/{file_name(index, ext)}", "rb") as f:
        return f.read()


def test_native_strategy_merge_with_and_without_throttle(tmp_dir):
    native, _ = _native_lib()
    write_sstable_fixture(
        tmp_dir, 0, [(b"k%04d" % i, b"va%d" % i, 5) for i in range(0, 200, 2)])
    write_sstable_fixture(
        tmp_dir, 2, [(b"k%04d" % i, b"vb%d" % i, 6) for i in range(1, 200, 2)])
    r1 = _native_merge(native, tmp_dir, 1, None)
    sched = tsched.ShareScheduler()
    r2 = _native_merge(native, tmp_dir, 3, sched.thread_throttle())
    assert r1.entry_count == r2.entry_count == 200
    d1, d3 = (_file(tmp_dir, i, "compact_data") for i in (1, 3))
    assert d1 == d3 and len(d1) > 0
    assert sched.bg_throttled_s == 0.0  # nothing marked foreground


def test_chunked_throttled_merge_io_byte_identical(tmp_dir, monkeypatch):
    native, lib = _native_lib()
    if not hasattr(lib, "dbeel_read_file_cb"):
        pytest.skip("chunked IO entry points unavailable")
    write_sstable_fixture(
        tmp_dir, 0, [(b"c%05d" % i, b"A" * 96, 5) for i in range(0, 2000, 2)])
    write_sstable_fixture(
        tmp_dir, 2, [(b"c%05d" % i, b"B" * 96, 6) for i in range(1, 2000, 2)])
    r_plain = _native_merge(native, tmp_dir, 1, None)
    monkeypatch.setattr(native, "_IO_CHUNK_BYTES", 4096)
    monkeypatch.setattr(native, "ODIRECT_MIN_BYTES", 0)

    class CountingThrottle:
        def __init__(self, inner):
            self.inner = inner
            self.n = 0

        def tick(self):
            self.n += 1
            self.inner.tick()

    t = CountingThrottle(tsched.ShareScheduler().thread_throttle())
    r_chunked = _native_merge(native, tmp_dir, 3, t)
    assert r_plain.entry_count == r_chunked.entry_count == 2000
    for ext in ("compact_data", "compact_index"):
        a, b = _file(tmp_dir, 1, ext), _file(tmp_dir, 3, ext)
        assert a == b and len(a) > 0, ext
    assert t.n > 100, t.n


def _slice_scenario(m, clock):
    """bg_slice around units that tick internally, with foreground
    marks on a schedule, and the overload gate delaying a unit."""
    s = m.sched.ShareScheduler(1000, 250)
    gated = []

    async def gate():
        gated.append(clock.monotonic())
        clock.sleep(0.3)

    async def main():
        trail = []
        for unit in range(6):
            busy = unit % 3 != 0
            s.overload_gate = gate if unit == 4 else None
            async with s.bg_slice(gated=unit != 5):
                thr = s.thread_throttle()
                for quantum in range(unit + 1):
                    if busy:
                        s.fg_mark()
                    clock.sleep(0.01 * (quantum + 1))
                    thr.tick()
                clock.sleep(0.05)
            trail.append((unit, s.stats()))
            clock.sleep(3.0)
        return trail

    return run(main(), timeout=10), gated


def test_bg_slice_schedule_agrees(clocked):
    trail, gated = _both(clocked, _slice_scenario, step=0.0005)
    stats = trail[-1][1]
    assert stats["background_units"] == 6 and len(gated) == 1
    assert stats["background_throttled_s"] > 0
    assert stats["background_precharged_s"] > 0


# ---------------------------------------------------------------------
# The throttle on the port's merge (the device strategy's plain
# versions, on the CPU), as the shard wires it
# ---------------------------------------------------------------------


def _runs_for_merge(d, seed):
    rng = np.random.default_rng(seed)
    idx = []
    for r in range(4):
        ids = np.unique(rng.integers(0, 4000, size=600))
        entries = [(b"key-%06d" % int(i) + b"x" * int(i % 5),
                    rng.bytes(int(rng.integers(0, 40))),
                    int(rng.integers(1, 1 << 40))) for i in ids]
        write_sstable_fixture(d, 2 * r, entries)
        idx.append(2 * r)
    return idx


def _merge_sha(strategy, d, idx, out):
    from dbeel_tpu_torch.storage.sstable import SSTable

    srcs = [SSTable(d, i, None) for i in idx]
    try:
        res = strategy.merge(srcs, d, out, None, False, 1)
    finally:
        for s in srcs:
            s.close()
    h = hashlib.sha256()
    for ext in ("compact_data", "compact_index", "compact_bloom",
                "compact_sums"):
        h.update(_file(d, out, ext))
    return res.entry_count, h.hexdigest()


@pytest.mark.parametrize("busy", [False, True])
def test_throttled_device_merge_on_cpu(tmp_dir, clocked, busy):
    from dbeel_tpu_torch.storage.compaction import get_strategy

    idx = _runs_for_merge(tmp_dir, 9)
    strategy = get_strategy("device", device="cpu")
    want = _merge_sha(strategy, tmp_dir, idx, 101)
    m, clock = clocked("port", step=0.0001)
    cfg = m.config.parse_args([])
    sched = m.sched.ShareScheduler(
        cfg.foreground_tasks_shares, cfg.background_tasks_shares)
    strategy.throttle = sched.thread_throttle()
    if busy:
        sched.fg_mark()
    assert _merge_sha(strategy, tmp_dir, idx, 103) == want
    st = sched.stats()
    assert st["background_precharged_s"] > 0
    if busy:
        assert st["background_throttled_s"] > 0
    else:
        assert st["background_throttled_s"] == 0
    # The reference's device strategy under the same clock ticks the
    # same quanta.
    from dbeel_tpu.storage.compaction import get_strategy as jget

    jm, _ = clocked("ref", step=0.0001)
    jsch = jm.sched.ShareScheduler(1000, 250)
    jstrategy = jget("device")
    jstrategy.throttle = jsch.thread_throttle()
    if busy:
        jsch.fg_mark()
    assert _merge_sha(jstrategy, tmp_dir, idx, 105) == want
    assert jsch.stats() == st


# ---------------------------------------------------------------------
# metrics + trace
# ---------------------------------------------------------------------


_OPS = ["set", "get", "delete", "multi_get", "scan", "get_stats",
        "bogus", "invalid"]


def _metrics_scenario(m, clock):
    rng = np.random.default_rng(21)
    hist = m.metrics.LatencyHistogram()
    for us in rng.lognormal(5, 2.5, size=3000).astype(np.int64):
        hist.record_us(int(us))
    empty = m.metrics.LatencyHistogram().snapshot()
    pct = [hist.percentile_us(q) for q in (0, 0.001, 0.5, 0.9, 0.99, 1.0)]

    sm = m.metrics.ShardMetrics()
    sm.recorder = m.trace.FlightRecorder(0, sm.slow_op_us, capacity=64)
    kinds = sorted(m.errors._BY_KIND)
    for i in range(2000):
        op = _OPS[int(rng.integers(len(_OPS)))]
        started = clock.monotonic()
        clock.sleep(float(rng.exponential(0.03)))
        err = None
        if rng.random() < 0.1:
            err = m.errors.classify_error(
                m.errors._BY_KIND[kinds[int(rng.integers(len(kinds)))]]("e"))
            sm.record_error(err)
        sm.record_request(op, started, err, traced=bool(rng.random() < 0.05))
        sm.record_pipeline_depth(int(rng.integers(0, 40)))
        sm.record_batch_size(int(rng.integers(0, 300)))
        if rng.random() < 0.02:
            sm.record_hol_wait()
    sm.record_error("unknown-class")
    return (hist.snapshot(), empty, pct, sm.snapshot(), sm.slow_ops,
            sm.last_point_op_mono, sm.recorder.dump())


def test_metrics_histograms_and_hub_agree(clocked):
    snap, empty, _, hub, slow, _, dump = _both(clocked, _metrics_scenario)
    assert snap["count"] == 3000 and empty["p50_us"] is None
    assert slow > 0 and dump["slow_captured"] > 0
    assert hub["errors"]["other"] > 0


def _trace_scenario(m, clock):
    m.trace._ids = itertools.count(1)
    rng = np.random.default_rng(8)
    rec = m.trace.FlightRecorder(sample_every=5, slow_op_us=20_000,
                                 capacity=32)
    spans = []
    for i in range(1500):
        clock.sleep(float(rng.exponential(0.002)))
        err = "overload" if rng.random() < 0.08 else None
        if rec.tick():
            ctx = m.trace.TraceCtx(m.trace.new_trace_id(), op="set",
                                   collection="c",
                                   client_stamped=bool(i % 2))
            for stage in ("queue", "prep", "prep", "wal", "respond"):
                clock.sleep(float(rng.exponential(0.004)))
                ctx.mark(stage)
            ctx.note("local_write_us", int(rng.integers(1000)))
            resp = m.trace.split_peer_span(
                ["response", "set", [int(rng.integers(100)), 7]])[0]
            ctx.absorb_peer("n2", int(rng.integers(5000)),
                            m.msgs.pack_message(["response", "set", [1, 2]]))
            ctx.absorb_peer("n3", 5, b"\xc1junk")
            ctx.replica("n4", 9, None)
            spans.append((resp, rec.record_span(ctx, err)))
        else:
            rec.note_op("get", int(rng.exponential(15_000)), err)
    cases = [
        ["response", "set", [10, 20]], ["response", "set"],
        ["response", "get", [b"v", 5], [1, 2]], ["response", "get", [7, 9]],
        ["response", "error", "Internal", "boom"], ["response", "x", [1]],
        ["response", "multi_get", [None], [3, -1]], "junk", [],
        ["response", "range_pull", [[b"k", b"v", 1]], (4, 5)],
    ]
    splits = [m.trace.split_peer_span(c) for c in cases]
    return spans, splits, rec.dump(), rec.stats()


def test_flight_recorder_and_spans_agree(clocked):
    spans, _, dump, stats = _both(clocked, _trace_scenario)
    assert len(dump["entries"]) == 32 and stats["evicted"] > 0
    assert stats["sampled"] == len(spans) > 0
    assert spans[0][1]["replicas"][0] == {
        "node": "n2", "rtt_us": spans[0][1]["replicas"][0]["rtt_us"],
        "stages": [1, 2]}
    assert spans[0][1]["replicas"][1]["stages"] is None
    assert stats["slow_captured"] > 0 and stats["error_captured"] > 0
    # Stages partition the span: their sum never exceeds the total.
    for _, entry in spans:
        assert sum(us for _n, us in entry["stages"]) <= entry["total_us"]


def test_recorder_minimal_capture_rate_limit(clocked):
    def scenario(m, clock):
        rec = m.trace.FlightRecorder(0, 1000, capacity=4096)
        for i in range(1000):
            rec.note_op("set", 5000, None)
            if i % 100 == 0:
                clock.sleep(0.25)
        return rec.stats(), rec.tick(), rec.sampling

    stats, tick, sampling = _both(clocked, scenario)
    assert stats["capture_suppressed"] > 0 and not tick and not sampling


# ---------------------------------------------------------------------
# qos
# ---------------------------------------------------------------------


def _bucket_scenario(m, clock):
    rng = np.random.default_rng(4)
    out = []
    for rate in (1, 10, 1000):
        b = m.qos.TokenBucket(rate, now=0.0)
        t = 0.0
        for _ in range(300):
            t += float(rng.exponential(0.2))
            n = float(rng.integers(0, 3 * rate))
            if rng.random() < 0.3:
                b.debit(n, now=t)
                out.append(("debit", round(b.tokens, 9)))
            else:
                out.append((b.take(n, now=t), round(b.tokens, 9)))
        live = m.qos.TokenBucket(rate)
        clock.sleep(0.7)
        out.append((live.take(rate), round(live.tokens, 9)))
    return out


def test_token_bucket_refill_agrees(clocked):
    out = _both(clocked, _bucket_scenario)
    assert any(o[0] is False for o in out) and any(o[0] is True for o in out)


def _qos_scenario(m, clock):
    rng = np.random.default_rng(12)
    cfg = m.config.Config(tenant_ops_per_sec=50, tenant_bytes_per_sec=4000,
                          pipeline_window_max=32, overload_window_min=2)
    levels = [0, 0, 0]
    cols = {"users": SimpleNamespace(quotas={"ops_per_sec": 5}),
            "logs": SimpleNamespace(quotas={"bytes_per_sec": 100}),
            "plain": SimpleNamespace(quotas=None)}
    shard = SimpleNamespace(
        governor=SimpleNamespace(class_level=lambda c: levels[c]),
        collections=cols, shard_name="shard-0", dataplane=None)
    plane = m.qos.QosPlane(shard, cfg)
    plane.MAX_BUCKETS = 8
    out = []
    tenants = [None, "t1", "t2", "t3"] + [f"x{i}" for i in range(12)]
    for step in range(3000):
        what = rng.random()
        cls = int(rng.integers(3))
        if what < 0.05:
            levels[int(rng.integers(3))] = int(rng.integers(3))
        elif what < 0.35:
            plane.begin(cls)
            out.append(("shed", cls, plane.should_shed(cls)))
            plane.end(cls)
        elif what < 0.45:
            plane.begin(cls)
        elif what < 0.7:
            tenant = tenants[int(rng.integers(len(tenants)))]
            col = ["users", "logs", "plain", 7][int(rng.integers(4))]
            try:
                plane.charge_ops(tenant, col, int(rng.integers(1, 4)))
                out.append(("ok", tenant))
            except m.errors.QuotaExceeded as e:
                out.append(("quota", str(e)))
            plane.charge_bytes(tenant, col, int(rng.integers(0, 300)))
        elif what < 0.75:
            plane.note_peer(cls)
        elif what < 0.78:
            out.append(("shed_error", str(plane.shed_error(cls))))
        else:
            clock.sleep(float(rng.exponential(0.05)))
    requests = [
        {}, {"qos": "batch"}, {"qos": 0, "tenant": "t"}, {"tenant": ""},
        {"tenant": 5}, {"qos": "vip", "tenant": "a"},
    ]
    heads = [(m.qos.request_class(r), m.qos.request_tenant(r))
             for r in requests]
    return out, plane.stats(), heads, plane.quota_rates("users")


def test_qos_plane_admission_agrees(clocked):
    out, stats, heads, rates = _both(clocked, _qos_scenario)
    assert stats["quota_refusals"] > 0
    assert any(o[0] == "shed" and o[2] for o in out)
    assert heads[1] == (2, None) and rates == (5, 4000)


# ---------------------------------------------------------------------
# governor: a stub shard holding one LSMTree of each package
# ---------------------------------------------------------------------


class _PendingTask:
    def done(self):
        return False


def _gov_scenario(pkg, tmp_dir, m, clock):
    if pkg == "ref":
        from dbeel_tpu.storage import LSMTree
        from dbeel_tpu.storage.compaction import get_strategy
        strategy = get_strategy("cpu")
    else:
        from dbeel_tpu_torch.storage import LSMTree
        from dbeel_tpu_torch.storage.compaction import get_strategy
        strategy = get_strategy("cpu")
    cap = 32
    tree = LSMTree.open_or_create(
        os.path.join(tmp_dir, pkg), capacity=cap, strategy=strategy,
        memtable_kind="sorted")
    cfg = m.config.Config(overload_compaction_debt=4, overload_soft_ops=8,
                          overload_hard_ops=20)
    conn = SimpleNamespace(pending=deque(), parked=deque(), inflight=set())

    def spawn(coro):
        coro.close()
        return _PendingTask()

    shard = SimpleNamespace(
        db_connections=[conn], collections={"c": SimpleNamespace(tree=tree)},
        spawn=spawn, dataplane=None, shard_name="s0")
    gov = m.governor.LoadGovernor(shard, cfg)
    rng = np.random.default_rng(2)
    trail = []

    def look(tag):
        clock.sleep(2 * gov.SAMPLE_S)
        level = gov.level()
        trail.append((
            tag, level, tuple(gov.class_level(c) for c in range(3)),
            tuple(tuple(sorted(gov.soft_reasons(c))) for c in range(3)),
            gov.memtable_only_soft(), gov.should_shed(),
            gov.any_should_shed(), gov.soft_overloaded(), gov.stats(),
        ))

    async def write(n, base):
        for i in range(n):
            key = b"k%05d" % int(rng.integers(0, 1 << 16))
            await tree.set_with_timestamp(key, rng.bytes(8), base + i)

    async def main():
        look("empty")
        await write(int(cap * 0.9), 1000)
        look("memtable")
        await tree.flush()
        look("flushed")
        for t in range(7):
            await write(cap, 10_000 * (t + 2))
            await tree.flush()
            look(f"debt{t}")
        # Update-heavy: one hot key, appends below the flush trigger.
        for i in range(cap - 1):
            await tree.set_with_timestamp(b"hot", b"v%d" % i, 900_000 + i)
        look("appends")
        await tree.flush()
        for n in (5, 9, 14, 21, 0):
            conn.pending.extend(range(n))
            look(f"ops{n}")
            conn.pending.clear()
        for i in range(40):
            gov.note_completion(dead=i % 3 != 0)
        look("dead")
        for i in range(60):
            gov.note_completion(dead=False)
        look("alive")
        for lvl in (2, 1, 0, None):
            gov.force_level(lvl)
            look(f"forced{lvl}")
        gov.record_shed("set")
        gov.record_shed("get")
        gov.note_window(3.5, True)
        gov.note_window(8.0, False)
        gov.python_sheds += 1
        look("counters")

    run(main(), timeout=60)
    tree.close()
    return trail


def test_governor_signals_and_levels_agree(tmp_dir, clocked):
    got = {pkg: _gov_scenario(pkg, tmp_dir, *clocked(pkg))
           for pkg in ("ref", "port")}
    assert got["port"] == got["ref"]
    by_tag = {t[0]: t for t in got["port"]}
    assert by_tag["empty"][1] == 0
    assert by_tag["memtable"][3][1] == ("memtable",) and by_tag["memtable"][4]
    assert by_tag["appends"][8]["signals"]["memtable_fill"] == 0.969
    # Past overload_compaction_debt: batch first, standard, then not
    # interactive until its 1.5x bar.
    assert by_tag["debt6"][8]["signals"]["sstable_debt"] == 8
    assert "debt" in by_tag["debt6"][3][1]
    assert by_tag["debt1"][2] == (0, 0, 1)
    assert by_tag["ops21"][1] == 2 and by_tag["forced2"][2] == (1, 2, 2)
    assert by_tag["counters"][8]["shed_by_op"] == {"set": 1, "get": 1}


def test_governor_bg_gate_agrees(clocked, monkeypatch):
    def scenario(m, clock):
        async def fake_sleep(dt):
            clock.sleep(dt)
            await _real_sleep(0)

        cfg = m.config.Config()
        shard = SimpleNamespace(
            db_connections=[], collections={}, dataplane=None,
            spawn=lambda coro: (coro.close(), _PendingTask())[1])
        gov = m.governor.LoadGovernor(shard, cfg)

        async def main():
            await gov.bg_gate()
            gov.force_level(1)
            await gov.bg_gate()
            gov.force_level(None)
            return gov.stats()

        monkeypatch.setattr(asyncio, "sleep", fake_sleep)
        try:
            return run(main(), timeout=10)
        finally:
            monkeypatch.setattr(asyncio, "sleep", _real_sleep)

    st = _both(clocked, scenario)
    assert st["bg_delays"] == 1 and st["bg_delayed_s"] >= 5.0


# ---------------------------------------------------------------------
# hints
# ---------------------------------------------------------------------


def _hint_scenario(m, clock, path, monkeypatch):
    monkeypatch.setattr(m.hints, "COMPACT_MIN_GARBAGE", 40)
    monkeypatch.setattr(m.hints, "COMPACT_MIN_BYTES", 0)
    rng = np.random.default_rng(17)
    log = m.hints.HintLog(path, max_per_node=30, ttl_s=200.0)
    nodes = [f"node-{i}" for i in range(4)]
    trail = []
    for step in range(1500):
        node = nodes[int(rng.integers(len(nodes)))]
        what = rng.random()
        if what < 0.7:
            key = rng.bytes(int(rng.integers(1, 12)))[:3]
            ts = int(rng.choice([1, 255, 65536, 2**40, 2**63 - 1]))
            trail.append(log.record(node, f"c{int(rng.integers(3))}", key, ts))
        elif what < 0.8:
            page = log.take_page(node, int(rng.integers(1, 10)))
            trail.append(len(page))
            if rng.random() < 0.5:
                log.requeue(node, page[: len(page) // 2])
                log.mark_drained(node, len(page) - len(page) // 2,
                                 drop_marker=False)
            else:
                log.mark_drained(node, len(page))
        elif what < 0.84:
            trail.append(log.expire_ttl_dead(node))
        elif what < 0.85:
            trail.append(log.expire_node(node))
        elif what < 0.86:
            log.rewrite()
        else:
            clock.sleep(float(rng.exponential(2.0)))
    counters = (log.recorded, log.replayed, log.expired,
                log.dropped_capacity, log.queued_by_node(),
                log.queued_total(), log.nodes_with_hints(),
                [log.has(n) for n in nodes])
    log.close()
    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    return trail, counters, digest


def _reopen(m, path):
    log = m.hints.HintLog(path, max_per_node=60, ttl_s=0)
    queued = log.queued_by_node()
    pages = {n: log.take_page(n, 1000) for n in sorted(queued)}
    log.close()
    return queued, pages


def test_hint_log_files_equal_and_cross_open(tmp_dir, clocked, monkeypatch):
    paths = {pkg: os.path.join(tmp_dir, pkg, "hints-0.log")
             for pkg in ("ref", "port")}
    got = {pkg: _hint_scenario(*clocked(pkg), paths[pkg], monkeypatch)
           for pkg in ("ref", "port")}
    assert got["port"] == got["ref"]
    trail, counters, _ = got["port"]
    assert counters[0] > 0 and counters[2] > 0 and counters[3] > 0
    # Each package reopens the other's file to the same live set.
    j_of_t = _reopen(PKGS["ref"], paths["port"])
    t_of_j = _reopen(PKGS["port"], paths["ref"])
    assert j_of_t == t_of_j == _reopen(PKGS["port"], paths["port"])
    assert sum(j_of_t[0].values()) > 0
    # A torn tail and a junk record do not block a reload.
    with open(paths["port"], "ab") as f:
        f.write(b"\x05\x00\x00\x00\xc1\xc1\xc1\xc1\xc1\x09\x00")
    assert _reopen(PKGS["port"], paths["port"]) == j_of_t


# ---------------------------------------------------------------------
# telemetry
# ---------------------------------------------------------------------

_PATHS = [
    "metrics.requests.get.count", "metrics.requests.set.count",
    "metrics.errors.overload", "overload.shed_ops",
    "overload.deadline_drops", "convergence.hints_queued",
    "convergence.hints_recorded", "overload.signals.loop_lag_ms",
    "overload.signals.dead_completion_frac", "overload.level",
    "durability.degraded_mode", "durability.odirect_fallbacks",
    "wal_fsync_errors", "trace.evicted", "trace.capacity", "scan.sheds",
    "scan.chunks", "watch.lag_events", "qos.classes.batch.shed",
    "qos.classes.batch.admitted", "qos.classes.interactive.shed",
    "qos.classes.interactive.admitted", "atomic.cas_conflicts",
    "membership.migrations_active", "membership.keys_migrated",
]


def _tele_scenario(m, clock):
    rng = np.random.default_rng(31)
    ring = m.tele.TelemetryRing(capacity=12)
    dog = m.tele.HealthWatchdog()
    counters = {p: 0.0 for p in _PATHS}
    out = []
    for i in range(80):
        for p in _PATHS:
            if rng.random() < 0.15:
                continue
            if p.endswith(("level", "degraded_mode", "migrations_active")):
                counters[p] = int(rng.integers(0, 3) == 2)
            elif "frac" in p or "lag" in p:
                counters[p] = round(float(rng.random()), 3)
            elif p == "trace.capacity":
                counters[p] = 64
            else:
                counters[p] += int(rng.integers(0, 60)) * int(rng.random() < 0.7)
        flat = {p: v for p, v in counters.items() if rng.random() < 0.95}
        if i == 40:
            flat["overload.shed_ops"] = 0  # a restart: clamps to 0
        clock.sleep(float(rng.choice([0.0, 0.5, 1.0, 2.0])))
        ring.add_sample(flat, uptime_s=i * 1.04)
        out.append((ring.rates(), dog.evaluate(ring),
                    ring.series("overload.shed_ops", 3),
                    ring.delta_per_s("scan.chunks")))
        if i % 7 == 0:
            dog.observe(ring)
    return out, ring.dump(), dog.stats(), len(ring)


def test_telemetry_ring_rates_and_watchdog_agree(clocked):
    out, dump, dstats, n = _both(clocked, _tele_scenario)
    kinds = {f["kind"] for _, fs, _, _ in out for f in fs}
    assert {"shed_storm", "odirect_fallback", "wal_sync_errors"} <= kinds
    assert n == 12 and dump["evicted"] == 68 and dstats["findings_total"] > 0


def _stats_tree(rng, depth=0):
    node = {}
    for i in range(int(rng.integers(2, 6))):
        name = ["ops", "p99-us", "level", "a.b", "x y", "ok", "n"][i]
        r = rng.random()
        if depth < 3 and r < 0.3:
            node[name] = _stats_tree(rng, depth + 1)
        elif r < 0.45:
            node[name] = bool(rng.random() < 0.5)
        elif r < 0.6:
            node[name] = None
        elif r < 0.7:
            node[name] = [1, 2]
        elif r < 0.8:
            node[name] = "text"
        elif r < 0.9:
            node[name] = float(rng.random() * 1e6)
        else:
            node[name] = int(rng.integers(-2**40, 2**40))
    return node


def test_flatten_and_prometheus_text_agree():
    for seed in range(8):
        rng = np.random.default_rng(seed)
        stats = {"cluster": {"x": 1}, "telemetry": {"y": 2},
                 "health": {"ok": True}, **_stats_tree(rng)}
        for skip in (jtele.RING_SKIP_BLOCKS, jtele.PROM_SKIP_BLOCKS,
                     frozenset()):
            assert ttele.flatten_stats(stats, skip) == (
                jtele.flatten_stats(stats, skip))
        text = ttele.render_prometheus(stats, "shard-3")
        assert text == jtele.render_prometheus(stats, "shard-3")
        for line in text.splitlines():
            name = line.split(" ")[2] if line.startswith("#") else (
                line.split("{")[0])
            assert ttele.prom_ok(name), name
    assert ttele.prom_name("a.b-c d") == jtele.prom_name("a.b-c d")


def _shard_tele_scenario(m, clock):
    rng = np.random.default_rng(41)
    cfg = SimpleNamespace(telemetry_interval_ms=1000, telemetry_ring=6)
    tele = m.tele.ShardTelemetry(cfg)
    off = m.tele.ShardTelemetry(SimpleNamespace())
    spawned = []
    shard = SimpleNamespace(
        id=1, degraded=False,
        governor=SimpleNamespace(level=lambda: 1, telemetry_hook=None,
                                 _ensure_heartbeat=lambda: None),
        hint_log=SimpleNamespace(queued_total=lambda: 17),
        spawn=lambda coro: spawned.append(coro.close()))
    counter = {"n": 0}

    def get_stats():
        counter["n"] += int(rng.integers(0, 500))
        return {"ts_ms": int(clock.time() * 1000),
                "uptime_s": clock.monotonic() - 1000,
                "metrics": {"requests": {"get": {"count": counter["n"]}}},
                "overload": {"shed_ops": counter["n"] // 3, "level": 1},
                "durability": {"degraded_mode": counter["n"] % 2 == 0},
                "telemetry": {"skip": 1}}

    shard.get_stats = get_stats
    tele.start(shard)
    off.start(shard)
    samples = []
    for _ in range(40):
        clock.sleep(float(rng.choice([0.3, 0.7, 1.1])))
        samples.append(tele.maybe_sample())
    digests = [tele.shard_digest(shard), tele.shard_digest(),
               off.shard_digest()]
    digests.append({"seq": 9, "level": 2, "ops_per_s": 3.25,
                    "errors_per_s": None, "degraded": True,
                    "hint_backlog": 4, "findings": ["a"]})
    merged = m.tele.ShardTelemetry.merge_digests(
        "node-a", digests + ["junk"], boot="b0")
    return (samples, digests, merged, tele.stats_block(),
            tele.health_block(), off.health_block(), tele.dump(),
            off.stats_block(), shard.governor.telemetry_hook is not None,
            len(spawned))


def test_shard_telemetry_digests_agree(clocked):
    got = _both(clocked, _shard_tele_scenario)
    samples, digests, merged = got[:3]
    assert any(samples) and not all(samples)
    assert merged["shards"] == 5 and merged["level"] == 2
    assert merged["hint_backlog"] == 17 + 17 + 0 + 4
