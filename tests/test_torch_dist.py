"""dbeel_tpu_torch's distributed merge (K9b with its splitter pick, the
mesh sample sort),
its K7 sort + dedup and the mesh pipeline, against dbeel_tpu's.

The same seeded numpy inputs go through dbeel_tpu on JAX-CPU (the 8
virtual devices of tests/conftest.py) and through the port with
``device="cpu"`` on a mesh of repeated CPU devices
(``shard_mesh(n, devices=[cpu] * n)``), which runs the kernels' plain
PyTorch versions.  Every comparison is exact: the data is integer.
The ``cuda`` cases hold the CUDA kernels against their plain versions
on a card and skip without one.
"""

import asyncio
import hashlib
import os
import random

import numpy as np
import pytest
import torch

import jax

from conftest import write_sstable_fixture

from dbeel_tpu.ops import merge as jmerge
from dbeel_tpu.ops import pipeline as jpipe
from dbeel_tpu.parallel import dist_merge as jdm
from dbeel_tpu.parallel.mesh import shard_mesh as jmesh
from dbeel_tpu.storage import LSMTree as JTree
from dbeel_tpu.storage import columnar as jcol
from dbeel_tpu.storage.compaction import get_strategy as jget
from dbeel_tpu.storage.entry import encode_entry
from dbeel_tpu.storage.sstable import SSTable as JTable
from dbeel_tpu_torch.ops import merge as tmerge
from dbeel_tpu_torch.ops import pipeline as tpipe
from dbeel_tpu_torch.ops.bitonic import to_tensor
from dbeel_tpu_torch.parallel import dist_merge as tdm
from dbeel_tpu_torch.parallel.mesh import Mesh, shard_mesh
from dbeel_tpu_torch.storage import LSMTree as TTree
from dbeel_tpu_torch.storage import columnar as tcol
from dbeel_tpu_torch.storage.compaction import get_strategy as tget
from dbeel_tpu_torch.storage.entry import file_name
from dbeel_tpu_torch.storage.native import load as native_load
from dbeel_tpu_torch.storage.sstable import SSTable as TTable
from dbeel_tpu_torch.utils import msgpack_codec

CPU = torch.device("cpu")
SENT = 0xFFFFFFFF


def cpu_mesh(n):
    return shard_mesh(n, devices=[CPU] * n)


class FakeTable:
    def __init__(self, entries):
        self.entries_list = entries

    def read_index_columns(self):
        offs, ks, fs = [], [], []
        off = 0
        for k, v, ts in self.entries_list:
            offs.append(off)
            ks.append(len(k))
            fs.append(16 + len(k) + len(v))
            off += fs[-1]
        return (
            np.array(offs, np.uint64),
            np.array(ks, np.uint32),
            np.array(fs, np.uint32),
        )

    def read_data_bytes(self):
        return b"".join(
            encode_entry(k, v, ts) for k, v, ts in self.entries_list
        )


def _tables(key_sets, ts_of=lambda t: 100 + t):
    return [
        FakeTable([(k, b"v%d" % t, ts_of(t)) for k in sorted(keys)])
        for t, keys in enumerate(key_sets)
    ]


def _both(tables):
    return jcol.load_columns(tables), tcol.load_columns(tables)


def _random8(seed, n_tables=4, n_keys=300):
    """Random 8-byte keys, most with k0 >= 0x80000000, plus keys whose
    first word is 0xFFFFFFFF (the largest bucket's edge)."""
    rng = np.random.default_rng(seed)
    sets = []
    for _ in range(n_tables):
        raw = rng.integers(0, 256, (n_keys, 8), dtype=np.uint8)
        raw[: n_keys * 2 // 3, 0] |= 0x80
        raw[:5, :4] = 0xFF
        sets.append({bytes(x) for x in raw})
    return _tables(sets)


def _hot_long(seed, n_tables=4, n_keys=256):
    """__graft_entry__.py's shape, cut down: 24-byte keys plus a hot
    16-byte-prefix group of n/16 keys per run."""
    rng = np.random.default_rng(seed)
    hot = bytes(rng.integers(0, 256, 16, dtype=np.uint8))
    sets = []
    for _ in range(n_tables):
        keys = {bytes(x) for x in rng.integers(0, 256, (n_keys, 24),
                                               dtype=np.uint8)}
        keys.update(hot + bytes(rng.integers(0, 256, 8, dtype=np.uint8))
                    for _ in range(n_keys // 16))
        sets.append(keys)
    return _tables(sets)


def _skew(seed, n_tables=3, n_keys=300):
    """Every key shares its first word: one bucket takes everything."""
    rng = random.Random(seed)
    return _tables(
        [{b"AAAA" + rng.randbytes(6) for _ in range(n_keys)}
         for _ in range(n_tables)],
        ts_of=lambda t: 100,
    )


INPUTS = {"random8": _random8, "hot_long": _hot_long, "skew": _skew}


def _u32(t):
    return t.numpy().view(np.uint32)


# ----------------------------------------------------------------------
# Meshes
# ----------------------------------------------------------------------


def test_shard_mesh_repeats_devices_and_needs_a_card(monkeypatch):
    mesh = shard_mesh(4, devices=[CPU] * 4)
    assert isinstance(mesh, Mesh)
    assert mesh.size == 4 and mesh.axis_names == ("shards",)
    assert mesh.devices == (CPU,) * 4
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        shard_mesh()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert shard_mesh().devices == tuple(
        torch.device("cuda", i) for i in range(3)
    )
    assert shard_mesh(2).size == 2
    with pytest.raises(ValueError):
        shard_mesh(devices=[CPU, torch.device("cuda", 0)])


# ----------------------------------------------------------------------
# build_stack and the sharded program, bit for bit
# ----------------------------------------------------------------------


@pytest.mark.parametrize("n_dev", [2, 4, 8])
@pytest.mark.parametrize("n", [1, 31, 500, 4097])
def test_build_stack_bit_equal(n, n_dev):
    rng = np.random.default_rng(n)
    keys = {bytes(x) for x in rng.integers(0, 256, (n, 12), dtype=np.uint8)}
    assert len(keys) == n
    jc, tc = _both(_tables([keys]))
    want = jdm.build_stack(jc, n_dev)
    got = tdm.build_stack(tc, n_dev)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_dev", [2, 4, 8])
@pytest.mark.parametrize("shape", sorted(INPUTS))
def test_dist_kernel_outputs_bit_equal(shape, n_dev):
    """(out, same, overflow) of the port's _dist_kernel equal JAX's
    shard_map program: the K5 local sorts, K9b's unsigned splitters,
    buckets, drops and overflow, and both exchanges."""
    jc, tc = _both(INPUTS[shape](n_dev))
    stack = jdm.build_stack(jc, n_dev)
    m = stack.shape[0] // n_dev
    capacity = int(m * 2.0 / n_dev) + jdm._NUM_SAMPLES
    jout, jsame, jover = jdm._dist_kernel(
        stack, mesh=jmesh(n_dev), capacity=capacity, n_dev=n_dev
    )
    outs, sames, overs = tdm._dist_kernel(
        tdm.build_stack(tc, n_dev), cpu_mesh(n_dev), capacity, n_dev
    )
    np.testing.assert_array_equal(
        np.concatenate([_u32(o) for o in outs]), np.asarray(jout)
    )
    np.testing.assert_array_equal(
        np.concatenate([s.numpy() for s in sames]), np.asarray(jsame)
    )
    over = np.concatenate([_u32(o) for o in overs])
    np.testing.assert_array_equal(over, np.asarray(jover))
    # Two partitions hold m + 32 rows each: nothing can overflow.
    if shape == "skew" and n_dev > 2:
        assert over.sum() > 0
    else:
        assert over.sum() == 0


def _sorted_local(rng, m, n_valid, hi_words):
    """A sorted (m, 9) local stack: ``n_valid`` rows with k0 drawn
    from ``hi_words`` (ties across splitters, k0 >= 0x80000000,
    0xFFFFFFFF), then sentinel rows."""
    rows = rng.integers(0, 1 << 32, (m, 9), dtype=np.uint64).astype(np.uint32)
    rows[:, 0] = rng.choice(hi_words, size=m)
    rows[:, 4] = rng.integers(0, 40, size=m).astype(np.uint32)
    rows[n_valid:] = SENT
    order = np.lexsort(rows[:n_valid, :8].T[::-1])
    rows[:n_valid] = rows[:n_valid][order]
    return rows


def _warp_search(m, pred):
    """csrc/dist.cu warp_search: the first row of [0, m) where ``pred``
    fails, 32 probes a round.  Returns (row, rounds)."""
    lo, hi, rounds = 0, m, 0
    lanes = np.arange(32)
    while lo < hi:
        step = (hi - lo + 31) >> 5
        probe = [x < hi and bool(pred(x)) for x in lo + lanes * step]
        c = sum(probe)
        assert all(probe[:c])  # pred holds on a prefix: its probes lead
        if c == 0:
            hi = lo
        else:
            top = lo + c * step
            lo += (c - 1) * step + 1
            hi = min(top, hi)
        rounds += 1
    assert rounds <= -(-m.bit_length() // 5) + 1
    return lo, rounds


def _order_samples_model(samples):
    """csrc/dist.cu order_samples: the bitonic network over the samples
    as unsigned words, padded with 0xFFFFFFFF to a power of two, stage
    by stage (one warp's registers run it up to 256 words, the block's
    shared memory above; the network is the same)."""
    s = samples.shape[0]
    n = 1 << (s - 1).bit_length()
    buf = np.full(n, SENT, np.uint64)
    buf[:s] = samples
    q = np.arange(n // 2)
    k = 2
    while k <= n:
        j = k // 2
        while j:
            lo = ((q & ~(j - 1)) << 1) | (q & (j - 1))
            a, c = buf[lo], buf[lo + j]
            swap = (a > c) == ((lo & k) == 0)
            buf[lo], buf[lo + j] = np.where(swap, c, a), np.where(swap, a, c)
            j //= 2
        k *= 2
    return buf


def _kernel_model(local, samples, capacity, n_dev):
    """csrc/dist.cu's K9b in numpy.  Its prologue orders the gathered
    samples (``_order_samples_model``) and takes splitter j as word
    (j+1) * 32 - 1 of them.  Each bucket's run of rows comes from the
    warp-wide searches (nvalid, starts[b], starts[b+1]); its slot of
    capacity * 9 words is written as the head words before the first
    16-byte boundary (the send buffer starts on one), 16-byte vectors
    and the tail words, a word being the run's next word while the run
    lasts and the sentinel after it.  The overflow sums every bucket's
    excess over the buckets' searched ends.  Asserts that every slot
    word is written once and no load leaves the run.  Returns (send,
    overflow, splitters)."""
    ordered = _order_samples_model(samples)
    splitters = ordered[32 * np.arange(1, n_dev) - 1].astype(np.uint32)
    m = local.shape[0]
    flat = local.reshape(-1)
    nvalid, _ = _warp_search(m, lambda r: local[r, 4] != SENT)

    def end(b):
        if b + 1 >= n_dev:
            return m
        return _warp_search(m, lambda r: local[r, 0] <= splitters[b])[0]

    words = capacity * 9
    send = np.zeros(n_dev * words, np.uint32)
    writes = np.zeros(n_dev * words, np.int64)
    over, prev = 0, 0
    for b in range(n_dev):
        start = min(end(b - 1), nvalid) if b else 0
        stop = max(start, min(end(b), nvalid))
        e = max(prev, min(end(b), nvalid))
        over += max(0, e - prev - capacity)
        prev = e
        copy = min(stop - start, capacity) * 9
        base, src = b * words, start * 9
        head = min(words, -base % 4)
        nvec = (words - head) // 4
        tail = head + 4 * nvec

        def load(x):
            if x >= copy:
                return SENT
            assert src + x < stop * 9
            return flat[src + x]

        def store(x, vals):
            send[base + x: base + x + len(vals)] = vals
            writes[base + x: base + x + len(vals)] += 1

        for x in list(range(head)) + list(range(tail, words)):
            store(x, [load(x)])
        for v in range(nvec):
            x = head + 4 * v
            store(x, [load(x + i) for i in range(4)])
    assert (writes == 1).all()
    return (send.reshape(n_dev, capacity, 9), np.array([over], np.uint32),
            splitters)


def _jax_splitters(samples, n_dev):
    """The JAX body's splitter step (dbeel_tpu/parallel/dist_merge.py
    :83-86, inside _per_device's shard_map) on JAX-CPU: the gathered
    samples sorted, every step-th kept."""
    import jax.numpy as jnp

    all_samples = jnp.sort(jnp.asarray(samples))
    step = all_samples.shape[0] // n_dev
    return np.asarray(all_samples[step - 1 :: step][: n_dev - 1])


def _jax_bucket_scatter(local, splitters, capacity, n_dev):
    """The JAX body's bucket + scatter (dbeel_tpu/parallel/
    dist_merge.py:88-102, inside _per_device's shard_map) on JAX-CPU."""
    import jax.numpy as jnp

    sent = jnp.uint32(SENT)
    local = jnp.asarray(local)
    splitters = jnp.asarray(splitters)
    m = local.shape[0]
    k0 = local[:, 0]
    bucket = jnp.sum(k0[:, None] > splitters[None, :], axis=1)
    valid = local[:, 4] != sent
    counts = jnp.sum(
        (bucket[:, None] == jnp.arange(n_dev)[None, :]) & valid[:, None],
        axis=0,
    )
    starts = jnp.concatenate(
        [jnp.zeros((1,), counts.dtype), jnp.cumsum(counts)[:-1]]
    )
    col = jnp.arange(m) - starts[bucket]
    overflow = jnp.sum((col >= capacity) & valid).astype(jnp.uint32)
    send = jnp.full((n_dev, capacity, 9), sent)
    send = send.at[bucket, col].set(
        jnp.where(valid[:, None], local, sent), mode="drop"
    )
    return np.asarray(send), np.asarray(overflow)[None]


_K9_WORDS = np.array(
    [0, 7, 0x7FFFFFFF, 0x80000000, 0x80000001, 0xC0000000, SENT - 1, SENT],
    dtype=np.uint64,
)


def _k9b_edge(name, rng):
    """K9b's edge cases (chip_smoke.py phase 2 runs them on the card):
    (n_dev, local, splitters, capacity, rows cut off the front)."""
    spl4 = np.array([7, 0x80000000, 0xC0000000], np.uint32)
    if name == "empty_bucket":  # equal splitters: bucket 1 holds nothing
        return 4, _sorted_local(rng, 512, 400, _K9_WORDS), np.array(
            [7, 7, 0x80000000], np.uint32), 288, 0
    if name == "one_bucket_overflow":  # every valid row in bucket 1
        return 4, _sorted_local(rng, 512, 500, _K9_WORDS[3:4]), spl4, 40, 0
    if name == "nvalid_0":
        return 4, _sorted_local(rng, 512, 0, _K9_WORDS), spl4, 288, 0
    if name == "nvalid_m":
        return 4, _sorted_local(rng, 512, 512, _K9_WORDS), spl4, 288, 0
    if name == "m_capacity_odd":  # head and tail words in every slot
        return 4, _sorted_local(rng, 1027, 1001, _K9_WORDS), spl4, 259, 0
    if name == "view_off_16b":  # the stack one row into its storage
        return 4, _sorted_local(rng, 513, 480, _K9_WORDS), spl4, 289, 1
    if name == "n_dev_2":
        return 2, _sorted_local(rng, 513, 450, _K9_WORDS), np.array(
            [0x80000000], np.uint32), 289, 0
    if name == "n_dev_8":
        words = np.sort(rng.choice(_K9_WORDS, size=7).astype(np.uint32))
        return 8, _sorted_local(rng, 1024, 900, _K9_WORDS), words, 150, 0
    raise KeyError(name)


K9B_EDGES = ["empty_bucket", "one_bucket_overflow", "nvalid_0", "nvalid_m",
             "m_capacity_odd", "view_off_16b", "n_dev_2", "n_dev_8"]


def _samples_for(splitters, rng):
    """Gathered samples whose splitters are ``splitters`` (ascending):
    32 copies of each and of 0xFFFFFFFF, shuffled."""
    vals = np.repeat(np.append(splitters, np.uint32(SENT)), 32)
    return rng.permutation(vals).astype(np.uint32)


@pytest.mark.parametrize("seed", list(range(6)) + K9B_EDGES)
def test_k9_plain_versions_and_kernel_design(seed):
    """The splitter pick sorts as unsigned words; K9b's wrapper on CPU
    tensors (the plain pick and scatter), the JAX body's own bucket +
    scatter and a numpy model of the CUDA kernel's design (the samples
    ordered in the prologue, searched runs, range copies, sentinel
    fill) agree on sorted stacks with ties across splitters, high
    words, sentinel padding and overflow (the seeds), and on K9b's edge
    cases, whose samples are made to give their splitters."""
    if isinstance(seed, int):
        rng = np.random.default_rng(seed)
        n_dev = [2, 4, 8][seed % 3]
        samples = rng.choice(_K9_WORDS, size=n_dev * 32).astype(np.uint32)
        want = np.sort(samples)[31::32][: n_dev - 1]
        m = 512
        local = _sorted_local(rng, m, int(rng.integers(0, m + 1)), _K9_WORDS)
        capacity = [m // n_dev, 2 * m // n_dev + 32, 40][seed % 3]
        cut = 0
    else:
        rng = np.random.default_rng(K9B_EDGES.index(seed) + 100)
        n_dev, local, want, capacity, cut = _k9b_edge(seed, rng)
        samples = _samples_for(want, rng)
    smp = torch.from_numpy(samples.view(np.int32))
    np.testing.assert_array_equal(_u32(tdm.splitters_plain(smp, n_dev)), want)
    stack = torch.from_numpy(local.view(np.int32))[cut:]
    send, over, spl = tdm.bucket_scatter_kernel(stack, smp, capacity, n_dev)
    view = local[cut:]
    j_send, j_over = _jax_bucket_scatter(view, want, capacity, n_dev)
    k_send, k_over, k_spl = _kernel_model(view, samples, capacity, n_dev)
    for got, other in ((_u32(spl), want), (k_spl, want),
                       (_u32(send), j_send), (_u32(over), j_over),
                       (_u32(send), k_send), (_u32(over), k_over)):
        np.testing.assert_array_equal(got, other)
    if seed == "empty_bucket":
        assert (_u32(send)[1] == SENT).all()
    if seed == "one_bucket_overflow":
        assert int(_u32(over)[0]) == 500 - capacity
    if seed == "nvalid_0":
        assert (_u32(send) == SENT).all() and int(_u32(over)[0]) == 0


@pytest.mark.parametrize("n_dev", [2, 4, 8, 192])
@pytest.mark.parametrize("seed", range(2))
def test_k9b_splitter_pick_equals_sort_and_jax(n_dev, seed):
    """The fused prologue's pick (the bitonic network, in one warp's
    registers up to 256 samples and in shared memory above: n_dev 192
    pads 6144 samples to 8192) equals
    np.sort(samples)[31::32][:n_dev-1], the plain pick and the JAX
    body's own splitter step, on samples of few values (runs of equal
    samples across the splitter positions) and of random words."""
    rng = np.random.default_rng(seed)
    s = n_dev * 32
    if seed == 0:
        samples = rng.choice(_K9_WORDS, size=s).astype(np.uint32)
    else:
        samples = rng.integers(0, 1 << 32, size=s, dtype=np.uint64)
        samples = samples.astype(np.uint32)
    want = np.sort(samples)[31::32][: n_dev - 1]
    local = _sorted_local(rng, 256, 200, _K9_WORDS)
    _, _, k_spl = _kernel_model(local, samples, 64, n_dev)
    plain = tdm.splitters_plain(torch.from_numpy(samples.view(np.int32)),
                                n_dev)
    for got in (k_spl, _u32(plain), _jax_splitters(samples, n_dev)):
        np.testing.assert_array_equal(got, want)


def test_k9_wrappers_refuse_bad_operands():
    stack = torch.zeros((64, 9), dtype=torch.int32)
    # The pick's sample count: n_dev * 32, n_dev in 2..192.
    with pytest.raises(ValueError):
        tdm.bucket_scatter_kernel(stack, torch.zeros(60, dtype=torch.int32),
                                  40, 2)
    with pytest.raises(ValueError):
        tdm.bucket_scatter_kernel(stack, torch.zeros(32, dtype=torch.int32),
                                  40, 1)
    with pytest.raises(ValueError):
        tdm.bucket_scatter_kernel(
            torch.zeros((64, 8), dtype=torch.int32),
            torch.zeros(64, dtype=torch.int32), 40, 2,
        )
    with pytest.raises(ValueError):
        tdm.bucket_scatter_kernel(
            torch.zeros((64, 9), dtype=torch.int64),
            torch.zeros(64, dtype=torch.int32), 40, 2,
        )


# ----------------------------------------------------------------------
# tests/test_dist_merge.py, port counterparts (against numpy and JAX)
# ----------------------------------------------------------------------


def _random_tables(seed, n_tables=4, n_keys=500):
    rng = random.Random(seed)
    tables = []
    for t in range(n_tables):
        d = {}
        for _ in range(n_keys):
            d[rng.randbytes(8)] = (f"v{t}".encode(), rng.randrange(100, 105))
        tables.append(
            FakeTable([(k, v, ts) for k, (v, ts) in sorted(d.items())])
        )
    return tables


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_distributed_matches_numpy_and_jax(n_dev):
    assert len(jax.devices()) >= n_dev
    jc, tc = _both(_random_tables(11))
    perm_np = tcol.sort_columns_numpy(tc)
    keep_np = tcol.dedup_mask(tc, perm_np)
    runs = tdm.dist_stats["runs"]
    perm, same = tdm.distributed_sort_dedup(tc, cpu_mesh(n_dev))
    assert tdm.dist_stats["runs"] == runs + 1
    np.testing.assert_array_equal(perm, perm_np)
    np.testing.assert_array_equal(~same, keep_np)
    jperm, jsame = jdm.distributed_sort_dedup(jc, jmesh(n_dev))
    np.testing.assert_array_equal(perm, jperm)
    np.testing.assert_array_equal(same, jsame)


def test_8dev_long_key_ties_near_capacity_no_fallback(monkeypatch):
    """24-byte keys with a hot equal-prefix group spanning every run:
    the mesh path runs (no overflow fallback) and, after the host
    fix-up, matches numpy and JAX exactly."""
    rng = np.random.default_rng(7)
    hot = bytes(rng.integers(0, 256, 16, dtype=np.uint8))
    sets = []
    for _ in range(4):
        keys = {bytes(x) for x in rng.integers(0, 256, (4096, 24),
                                               dtype=np.uint8)}
        keys.update(hot + bytes(rng.integers(0, 256, 8, dtype=np.uint8))
                    for _ in range(256))
        sets.append(keys)
    jc, tc = _both(_tables(sets))
    fell_back = []
    real = tdm._single_device_fallback
    monkeypatch.setattr(
        tdm, "_single_device_fallback",
        lambda c, d: fell_back.append(True) or real(c, d),
    )
    perm, _same = tdm.distributed_sort_dedup(tc, cpu_mesh(8))
    assert not fell_back, "exchange overflowed; mesh path never ran"
    perm = tcol.fixup_long_key_ties(tc, perm)
    keep = tcol.dedup_mask(tc, perm)
    perm_np = tcol.fixup_long_key_ties(tc, tcol.sort_columns_numpy(tc))
    np.testing.assert_array_equal(perm, perm_np)
    np.testing.assert_array_equal(keep, tcol.dedup_mask(tc, perm_np))
    jperm, _ = jdm.distributed_sort_dedup(jc, jmesh(8))
    np.testing.assert_array_equal(perm, jcol.fixup_long_key_ties(jc, jperm))


@pytest.mark.parametrize("cards", [1, 4])
def test_get_strategy_distributed_resolves_to_mesh(monkeypatch, cards):
    """distributed and auto resolve to the mesh strategy over every
    card when more than one is visible, to device on one; with no card
    they raise unless asked for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    for name in ("distributed", "auto"):
        strategy = tget(name)
        if cards > 1:
            assert strategy.name == "distributed"
            assert strategy.mesh.size == cards
            assert strategy.mesh.devices == tuple(
                torch.device("cuda", i) for i in range(cards)
            )
        else:
            assert strategy.name == "device"
            assert strategy.device.type == "cuda"
        cpu = tget(name, device="cpu")
        assert (cpu.name, cpu.device) == ("device", CPU)
    assert tget("device").name == "device"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("distributed", "auto"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tget(name)


def test_distributed_skew_falls_back_correctly():
    """All keys share the first word: everything buckets to one
    partition and overflows — the K4 path gives exact results, counted
    as a fallback with its overflow rows, as JAX's does."""
    jc, tc = _both(_skew(3))
    before = dict(tdm.dist_stats)
    perm, same = tdm.distributed_sort_dedup(tc, cpu_mesh(4))
    assert tdm.dist_stats["fallbacks"] == before["fallbacks"] + 1
    assert tdm.dist_stats["overflow_rows"] > before["overflow_rows"]
    assert tdm.dist_stats["runs"] == before["runs"]
    np.testing.assert_array_equal(perm, tcol.sort_columns_numpy(tc))
    jperm, jsame = jdm.distributed_sort_dedup(jc, jmesh(4))
    np.testing.assert_array_equal(perm, jperm)
    np.testing.assert_array_equal(same, jsame)


def test_one_partition_and_no_rows_take_the_single_card_path():
    jc, tc = _both(_random_tables(5, n_tables=2, n_keys=50))
    before = tdm.dist_stats["fallbacks"]
    perm, same = tdm.distributed_sort_dedup(tc, cpu_mesh(1))
    jperm, jsame = jdm.distributed_sort_dedup(jc, jmesh(1))
    np.testing.assert_array_equal(perm, jperm)
    np.testing.assert_array_equal(same, jsame)
    empty = tcol.load_columns([FakeTable([])])
    perm, same = tdm.distributed_sort_dedup(empty, cpu_mesh(4))
    assert perm.size == 0 and same.size == 0
    assert tdm.dist_stats["fallbacks"] == before + 2


# ----------------------------------------------------------------------
# K7: ops.merge.device_sort_dedup
# ----------------------------------------------------------------------


def _tie_heavy_tables(seed):
    """tests/test_device_merge.py:200-250: short keys, frequent
    timestamp collisions broken by source."""
    rng = random.Random(seed)
    tables = []
    for _ in range(4):
        entries = sorted({
            f"k{rng.randrange(300):03}".encode(): (
                f"v{rng.randrange(10)}".encode(), rng.randrange(100, 105),
            )
            for _ in range(200)
        }.items())
        tables.append(FakeTable([(k, v, ts) for k, (v, ts) in entries]))
    return tables


@pytest.mark.parametrize("seed", [9, 10])
def test_device_sort_dedup_equals_jax(seed):
    jc, tc = _both(_tie_heavy_tables(seed))
    perm, same = tmerge.device_sort_dedup(tc, "cpu")
    jperm, jsame = jmerge.device_sort_dedup(jc)
    np.testing.assert_array_equal(perm, jperm)
    np.testing.assert_array_equal(same, jsame)
    perm_np = tcol.sort_columns_numpy(tc)
    np.testing.assert_array_equal(perm, perm_np)
    np.testing.assert_array_equal(~same, tcol.dedup_mask(tc, perm_np))


def test_k7_padded_outputs_bit_equal_to_lax_sort():
    """The whole padded output — nine sorted operands and the mask over
    the padding rows too (no sentinel check) — equals lax.sort +
    _same_key_mask where no rows tie on all eight keys."""
    jc, tc = _both(_tie_heavy_tables(4))
    staged = tmerge.stage_columns(tc)
    assert staged.shape == (9, 1024)
    want = jmerge._sort_kernel(tuple(staged), num_keys=8)
    want_same = jmerge._same_key_mask(*want[:5])
    out, same = tmerge.sort_dedup_kernel(to_tensor(staged, "cpu"))
    np.testing.assert_array_equal(_u32(out), np.stack([np.asarray(w)
                                                       for w in want]))
    np.testing.assert_array_equal(same.numpy(), np.asarray(want_same))
    assert same[-1] and same[len(tc) + 1]  # padding rows compare equal


@pytest.mark.parametrize("n", [1, 5, 8, 9])
def test_k7_small_and_long_keys_after_fixup(n):
    """Long keys sharing a 16-byte prefix tie on all eight keys (where
    lax.sort's order is unspecified): equal to JAX and numpy after the
    host fix-up.  Sizes at and around the minimum padding of 8."""
    rng = random.Random(n)
    prefix = b"longprefix-0123456789abcdef-"
    sets = [{prefix + bytes([rng.randrange(65, 70)]) * rng.randrange(1, 5)
             for _ in range(n)} for _ in range(3)]
    jc, tc = _both(_tables(sets, ts_of=lambda t: 7))
    perm, _ = tmerge.device_sort_dedup(tc, "cpu")
    jperm, _ = jmerge.device_sort_dedup(jc)
    perm = tcol.fixup_long_key_ties(tc, perm)
    np.testing.assert_array_equal(perm, jcol.fixup_long_key_ties(jc, jperm))
    perm_np = tcol.fixup_long_key_ties(tc, tcol.sort_columns_numpy(tc))
    np.testing.assert_array_equal(perm, perm_np)
    np.testing.assert_array_equal(tcol.dedup_mask(tc, perm),
                                  tcol.dedup_mask(tc, perm_np))


def test_k7_wrapper_refuses_bad_operands(monkeypatch):
    with pytest.raises(ValueError):
        tmerge.sort_dedup_kernel(torch.zeros((9, 12), dtype=torch.int32))
    with pytest.raises(ValueError):
        tmerge.sort_dedup_kernel(torch.zeros((9, 4), dtype=torch.int32))
    with pytest.raises(ValueError):
        tmerge.sort_dedup_kernel(torch.zeros((8, 16), dtype=torch.int32))
    empty = tcol.load_columns([FakeTable([])])
    perm, same = tmerge.device_sort_dedup(empty, "cpu")
    assert perm.size == 0 and same.size == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmerge.device_sort_dedup(empty)


# ----------------------------------------------------------------------
# DistributedMergeStrategy: files byte-identical to heap and to JAX's
# ----------------------------------------------------------------------


def _dir_digest(d):
    out = {}
    for f in sorted(os.listdir(d)):
        with open(os.path.join(d, f), "rb") as fh:
            out[f] = hashlib.sha256(fh.read()).hexdigest()
    return out


def _tree_digest(d, tree_cls, strategy, keep, index_fields=None):
    """SHA-256 of a tree's files after writes, a flush and a major
    compaction.  With ``index_fields`` the values are msgpack documents
    holding those fields (the rows, and so the kernel shapes, are the
    same)."""

    def value(j):
        if not index_fields:
            return f"val{j}".encode()
        doc = {f: (j % 113 - 40 if j % 3 else f"v{j % 71}")
               for f in index_fields}
        return msgpack_codec.packb(doc if j % 17 else {"other": j})

    async def main():
        tree = tree_cls.open_or_create(
            d, capacity=300, strategy=strategy, bloom_min_size=1000,
            index_fields=index_fields,
        )
        rng = random.Random(42)
        # Diverse first words, so the exchange holds every bucket.
        keys = [f"{rng.randrange(400):04}:user".encode() for _ in range(900)]
        keys += [
            b"longprefix-0123456789abcdef-"
            + bytes([rng.randrange(65, 70)]) * rng.randrange(1, 5)
            for _ in range(200)
        ]
        keys += [rng.randbytes(rng.randint(4, 12)) for _ in range(300)]
        for j, k in enumerate(keys):
            await tree.set_with_timestamp(k, value(j), 10_000 + j)
        for j, k in enumerate(keys[::13]):
            await tree.delete_with_timestamp(k, 90_000 + j)
        others = [
            t for t in asyncio.all_tasks() if t is not asyncio.current_task()
        ]
        await asyncio.gather(*others)
        await tree.flush()
        idx = [i for i, _ in tree.sstable_indices_and_sizes()]
        await tree.compact(idx, max(idx) + 1, keep_tombstones=keep)
        tree.close()
        return _dir_digest(d)

    return asyncio.run(asyncio.wait_for(main(), 100))


@pytest.mark.parametrize("keep", [False, True])
def test_distributed_strategy_files_identical(tmp_dir, keep):
    ref = _tree_digest(f"{tmp_dir}/jheap", JTree, jget("heap"), keep)
    before = dict(tdm.dist_stats)
    got = _tree_digest(
        f"{tmp_dir}/tdist", TTree, tdm.DistributedMergeStrategy(cpu_mesh(4)),
        keep,
    )
    assert tdm.dist_stats["runs"] == before["runs"] + 1
    assert tdm.dist_stats["fallbacks"] == before["fallbacks"]
    assert got == ref
    assert got == _tree_digest(f"{tmp_dir}/theap", TTree, tget("heap"), keep)
    assert got == _tree_digest(
        f"{tmp_dir}/jdist", JTree, jdm.DistributedMergeStrategy(jmesh(4)),
        keep,
    )


def test_distributed_strategy_refuses_index_runs(tmp_dir):
    """With index fields the sample sort writes the output's index run
    (and its data) SHA-256-equal to dbeel_tpu's distributed merge."""
    ref = _tree_digest(f"{tmp_dir}/jdist", JTree,
                       jdm.DistributedMergeStrategy(jmesh(4)), False,
                       index_fields=["score"])
    before = dict(tdm.dist_stats)
    got = _tree_digest(f"{tmp_dir}/tdist", TTree,
                       tdm.DistributedMergeStrategy(cpu_mesh(4)), False,
                       index_fields=["score"])
    assert tdm.dist_stats["runs"] == before["runs"] + 1
    runs = {f: h for f, h in got.items() if f.endswith(("fidx", "fidx_sums"))}
    assert len(runs) == 2
    assert got == ref


# ----------------------------------------------------------------------
# The pipeline in mesh mode (tests/test_pipeline.py:245-300)
# ----------------------------------------------------------------------


def _sha_triplet(d, oi):
    h = hashlib.sha256()
    for ext in ("compact_data", "compact_index", "compact_bloom",
                "compact_sums"):
        p = f"{d}/{file_name(oi, ext)}"
        if os.path.exists(p):
            with open(p, "rb") as f:
                h.update(ext.encode())
                h.update(f.read())
    return h.hexdigest()


@pytest.mark.parametrize("n_dev", [4, 8])
def test_pipeline_mesh_byte_identical(tmp_dir, monkeypatch, n_dev):
    """The distributed strategy's big-merge path: the partitioned
    pipeline with its launch batch split over the mesh.  Output
    SHA-identical to heap and to JAX's pipeline_merge(mesh=...), and the
    mesh reached _pipeline_merge_impl, which produced the output."""
    if native_load() is None:
        pytest.skip("native library unavailable")
    rng = random.Random(23)
    for r in range(6):
        entries = {}
        for _ in range(700):
            k = rng.randbytes(rng.randint(8, 20))
            entries[k] = (rng.randbytes(rng.randint(0, 30)), 600 + r)
        write_sstable_fixture(
            tmp_dir, r * 2,
            [(k, v, ts) for k, (v, ts) in sorted(entries.items())],
        )
    idxs = [r * 2 for r in range(6)]
    ran = []
    real_impl = tpipe._pipeline_merge_impl

    def spy(*a, **kw):
        res = real_impl(*a, **kw)
        ran.append((res is not None, kw.get("mesh")))
        return res

    monkeypatch.setattr(tpipe, "_pipeline_merge_impl", spy)
    mesh = cpu_mesh(n_dev)
    strat = tdm.DistributedMergeStrategy(mesh)
    monkeypatch.setattr(type(strat), "PIPELINE_MIN_BYTES", 0)
    jstrat = jdm.DistributedMergeStrategy(jmesh(n_dev))
    monkeypatch.setattr(type(jstrat), "PIPELINE_MIN_BYTES", 0)
    jran = []
    jreal = jpipe._pipeline_merge_impl
    monkeypatch.setattr(
        jpipe, "_pipeline_merge_impl",
        lambda *a, **kw: jran.append(1) or jreal(*a, **kw),
    )
    results = {}
    for name, table_cls, runner, oi in (
        ("heap", TTable, tget("heap"), 101),
        ("mesh", TTable, strat, 103),
        ("jax mesh", JTable, jstrat, 105),
    ):
        srcs = [table_cls(tmp_dir, i, None) for i in idxs]
        res = runner.merge(srcs, tmp_dir, oi, None, False, 1)
        for s in srcs:
            s.close()
        results[name] = (_sha_triplet(tmp_dir, oi), res.entry_count,
                         res.data_size)
    assert results["heap"] == results["mesh"] == results["jax mesh"]
    assert ran == [(True, mesh)], "mesh pipeline did not produce the output"
    assert jran, "JAX's mesh pipeline did not run"


# ----------------------------------------------------------------------
# On the card
# ----------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(INPUTS))
def test_cuda_mesh_equals_cpu_mesh(cuda_device, shape):
    """The sharded program on four partitions of the card (K5, K9b
    and the copies) equals the plain versions' on the CPU."""
    _, tc = _both(INPUTS[shape](4))
    stack = tdm.build_stack(tc, 4)
    m = stack.shape[0] // 4
    capacity = int(m * 2.0 / 4) + 32
    got = tdm._dist_kernel(stack, shard_mesh(devices=[cuda_device] * 4),
                           capacity, 4)
    want = tdm._dist_kernel(stack, cpu_mesh(4), capacity, 4)
    torch.cuda.synchronize()
    for g_list, w_list in zip(got, want):
        for g, w in zip(g_list, w_list):
            assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(3))
def test_cuda_k7_k9_equal_plain(cuda_device, seed):
    """K9b's one launch from the gathered samples — send buffer,
    overflow word and the splitters block (0, 0) writes — and K7,
    bit-equal to their plain versions on the card."""
    rng = np.random.default_rng(seed)
    n_dev = 4
    words = np.array([0, 0x7FFFFFFF, 0x80000000, 0xC0000000, SENT],
                     dtype=np.uint64)
    samples = to_tensor(rng.choice(words, size=128).astype(np.uint32),
                        cuda_device)
    local = to_tensor(_sorted_local(rng, 4096, 3000 + seed, words),
                      cuda_device)
    for capacity in (1024, 2080, 300):
        before = tdm._cuda.launches["K9b"]
        got = tdm.bucket_scatter_kernel(local, samples, capacity, n_dev)
        assert tdm._cuda.launches["K9b"] == before + 1
        want = tdm.pick_scatter_plain(local, samples, capacity, n_dev)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    cols = rng.integers(0, 3, (9, 1 << 12), dtype=np.uint64).astype(np.uint32)
    cols[8] = rng.permutation(1 << 12).astype(np.uint32)
    cols[:, -100:] = SENT
    c = to_tensor(cols, cuda_device)
    for g, w in zip(tmerge.sort_dedup_kernel(c), tmerge.sort_dedup_plain(c)):
        assert torch.equal(g, w)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("name", K9B_EDGES)
def test_cuda_k9b_edges_equal_plain(cuda_device, name):
    """K9b's edge cases on the card, from samples made to give their
    splitters: send buffer, overflow word and splitters bit-equal to
    the plain version."""
    rng = np.random.default_rng(K9B_EDGES.index(name) + 100)
    n_dev, local, spl, capacity, cut = _k9b_edge(name, rng)
    stack = to_tensor(local, cuda_device)[cut:]
    s = to_tensor(_samples_for(spl, rng), cuda_device)
    got = tdm.bucket_scatter_kernel(stack, s, capacity, n_dev)
    assert np.array_equal(_u32(got[2].cpu()), spl)
    for g, w in zip(got, tdm.pick_scatter_plain(stack, s, capacity, n_dev)):
        assert torch.equal(g, w)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("n_dev", [2, 3, 8, 9, 16, 192])
def test_cuda_k9b_pick_equals_plain(cuda_device, n_dev):
    """The fused pick on the card at every way it orders the samples:
    one warp's registers at 2, 4 and 8 words a lane (n_dev 2, 3 and 8)
    and shared memory (n_dev 9, 16 and 192: 288, 512 and 6144 samples),
    on random words and on runs of equal samples."""
    rng = np.random.default_rng(n_dev)
    local = to_tensor(_sorted_local(rng, 8192, 8000, _K9_WORDS), cuda_device)
    for draw in (rng.integers(0, 1 << 32, size=n_dev * 32, dtype=np.uint64),
                 rng.choice(_K9_WORDS, size=n_dev * 32)):
        s = to_tensor(draw.astype(np.uint32), cuda_device)
        got = tdm.bucket_scatter_kernel(local, s, 100, n_dev)
        for g, w in zip(got, tdm.pick_scatter_plain(local, s, 100, n_dev)):
            assert torch.equal(g, w)
    torch.cuda.synchronize()
