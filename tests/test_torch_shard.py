"""dbeel_tpu_torch.server.shard (MyShard), server.db_server's envelope
helpers and the five LSMTree methods the shard calls, against
dbeel_tpu.

Both packages build the same shards from ``config.parse_args(["--dir",
d, ...])`` (tests/torch_shards.py); the port's run with ``device="cpu"``.
Every comparison is exact equality: ring state, ownership and plans
compared by shard names and hashes, shard responses compared as packed
peer frames, metadata files and WAL files byte for byte.  Per-boot
fields (``boot_id``, wall-clock stamps, the watch ring's boot epoch)
are masked by name where a comparison would otherwise read them."""

import asyncio
import hashlib
import os
import sys
import tempfile
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from dbeel_tpu import query as jquery
from dbeel_tpu.storage import LSMTree as JTree
from dbeel_tpu.storage import file_io as jfile_io
from dbeel_tpu.storage.compaction import get_strategy as jget
from dbeel_tpu_torch import query as tquery
from dbeel_tpu_torch.storage import LSMTree as TTree
from dbeel_tpu_torch.storage import file_io as tfile_io
from dbeel_tpu_torch.storage.compaction import get_strategy as tget
from dbeel_tpu_torch.utils import msgpack_codec as codec

from torch_shards import (  # noqa: F401
    PKGS,
    PER_BOOT,
    key_tree,
    make_node,
    make_shard,
    mask,
    no_leftovers,
    run,
    shutdown,
)


def _tree_names(shards):
    return [(s.name, s.hash) for s in shards]


def _arcs(arcs):
    return [(a, b, sorted(s.name for s in sel)) for a, b, sel in arcs]


# ---------------------------------------------------------------------
# The ring: ownership, arcs and migration plans
# ---------------------------------------------------------------------


def _metadata(m, name, n_shards, vnodes):
    tokens = None
    if vnodes > 1:
        tokens = [m.shard.vnode_tokens(f"{name}-{sid}", vnodes)
                  for sid in range(n_shards)]
    return m.msgs.NodeMetadata(
        name=name, ip="127.0.0.1", remote_shard_base_port=20000,
        ids=list(range(n_shards)), gossip_port=9, db_port=10000,
        tokens=tokens)


def _views(pkg, d, layout, vnodes):
    """One MyShard view per shard of every node in ``layout`` (a list
    of (node, shard count)), each knowing every other node."""
    m = PKGS[pkg]
    views = []
    for node, n in layout:
        shards = make_node(pkg, os.path.join(d, pkg, node), node, n,
                           extra=("--vnodes", str(vnodes)))
        for v in shards:
            v.add_shards_of_nodes([_metadata(m, o, c, vnodes)
                                   for o, c in layout if o != node])
        views.extend(shards)
    return views


_layouts = st.lists(st.integers(1, 3), min_size=1, max_size=4).map(
    lambda counts: [(f"node{chr(97 + i)}", c) for i, c in enumerate(counts)])
_hashes = st.lists(st.integers(0, 0xFFFFFFFF), min_size=1, max_size=12)


@pytest.mark.parametrize("vnodes", [1, 8])
@settings(max_examples=25, deadline=None)
@given(layout=_layouts, hashes=_hashes)
def test_ring_ownership_and_arcs_equal(vnodes, layout, hashes):
    """Equal ring order (names, hashes) after sort_consistent_hash_ring,
    equal owns_key at replica indices 0-2, preceding_replica_nodes,
    all_arcs and replica_arcs at rf 1-3, and the replica connections
    walked for each hash."""
    with tempfile.TemporaryDirectory() as d:
        got = {}
        for pkg in ("ref", "port"):
            views = _views(pkg, d, layout, vnodes)
            out = []
            for v in views:
                out.append(_tree_names(v.shards))
                for h in hashes:
                    out.append([v.owns_key(h, ri) for ri in range(3)])
                    out.append(v.preceding_replica_nodes(h))
                    out.append([n for n, _c in
                                v._replica_connections(2, h)])
                for rf in (1, 2, 3):
                    out.append(_arcs(v.all_arcs(rf)))
                    out.append(_arcs(v.replica_arcs(rf)))
            for v in views:
                v.close()
            got[pkg] = out
        assert got["port"] == got["ref"]


@pytest.mark.parametrize("vnodes", [1, 8])
@settings(max_examples=25, deadline=None)
@given(layout=_layouts.filter(lambda x: len(x) >= 2),
       rfs=st.lists(st.integers(1, 3), min_size=1, max_size=3))
def test_migration_plans_equal(vnodes, layout, rfs):
    """_plan_arc_diff for the addition and the removal of the last node
    (equal ranges, actions and target shards), and
    _plan_collection_actions over collections of the given rfs."""
    with tempfile.TemporaryDirectory() as d:
        got = {}
        for pkg in ("ref", "port"):
            views = _views(pkg, d, layout, vnodes)
            last = layout[-1][0]
            out = []
            for v in views:
                if v.config.name == last:
                    continue
                full = list(v.shards)
                old = [s for s in full if s.node_name != last]
                names = {id(s.connection): s.name for s in full}
                for rf in (1, 2, 3):
                    for a, b in ((old, full), (full, old)):
                        out.append([
                            (r.start, r.end, r.action,
                             names.get(id(r.connection)))
                            for r in v._plan_arc_diff(a, b, rf)])
                v.collections = {
                    f"c{i}": SimpleNamespace(replication_factor=rf)
                    for i, rf in enumerate(rfs)}
                out.append([
                    (name, [(r.start, r.end, r.action,
                             names.get(id(r.connection))) for r in plan])
                    for name, plan in v._plan_collection_actions(old, full)])
                v.collections = {}
            for v in views:
                v.close()
            got[pkg] = out
        assert got["port"] == got["ref"]


def _membership_state(v):
    return (
        _tree_names(v.shards),
        sorted(v.nodes),
        sorted(v.dead_nodes),
        {k: _tree_names(s) for k, s in sorted(v.departed_shards.items())},
        v.membership_epoch,
        sorted((k[0].split("#")[0], k[1]) for k in v.gossip_requests),
    )


@pytest.mark.parametrize("vnodes", [1, 8])
def test_gossip_and_dead_node_leave_equal_state(tmp_path, vnodes):
    """add_shards_of_nodes, then ALIVE gossip of a new node, DEAD gossip
    of one node, handle_dead_node of another and the first one's ALIVE
    again: after every step equal ring, nodes, dead_nodes,
    departed_shards and epoch; at the end equal peers.json files."""
    got = {}
    for pkg in ("ref", "port"):
        m = PKGS[pkg]
        G = m.msgs.GossipEvent

        async def main():
            d = str(tmp_path / pkg)
            v = make_node(pkg, d, "n0", 2, extra=("--vnodes", str(vnodes)))[0]
            steps = []
            v.add_shards_of_nodes([_metadata(m, "n1", 2, vnodes)])
            v.nodes["n1"] = _metadata(m, "n1", 2, vnodes)
            steps.append(_membership_state(v))
            for name in ("n2", "n3"):
                await v.handle_gossip_event(
                    G.alive(_metadata(m, name, 1, vnodes)))
                steps.append(_membership_state(v))
            again = await v.handle_gossip_event(G.alive(
                _metadata(m, "n2", 1, vnodes)))
            steps.append((again, _membership_state(v)))
            await v.handle_gossip_event(G.dead("n2"))
            steps.append(_membership_state(v))
            await v.handle_dead_node("n3")
            steps.append(_membership_state(v))
            await v.handle_gossip_event(G.alive(
                _metadata(m, "n2", 1, vnodes)))
            steps.append(_membership_state(v))
            while v._peers_written_version < v._peers_version:
                await asyncio.sleep(0.01)
            with open(os.path.join(d, "peers.json"), "rb") as f:
                peers = f.read()
            await shutdown(v)
            return steps, peers

        got[pkg] = run(main())
    assert got["port"] == got["ref"]
    steps, _peers = got["port"]
    assert steps[-2][2] == ["n2", "n3"] and steps[-1][2] == ["n3"]


# ---------------------------------------------------------------------
# The shard request handlers
# ---------------------------------------------------------------------

KINDS = ["ping", "telemetry_digest", "rearm", "get_metadata",
         "get_collections", "create_collection", "drop_collection", "set",
         "delete", "multi_set", "multi_get", "get", "get_digest",
         "range_digest", "range_pull", "scan", "watch_feed", "range_push"]


def _docs(seed, n):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        doc = {"v": int(rng.integers(0, 100)), "city": "abc"[i % 3]}
        out.append((codec.packb("doc-%04d" % i), codec.packb(doc),
                    1_000 + i))
    return out


async def _seeded(pkg, d):
    """A shard with collection "c" (rf 1) holding 300 flushed docs and
    40 newer writes in the memtable, and commits recorded."""
    s = make_shard(pkg, d)
    await s.create_collection("c", 1)
    tree = s.collections["c"].tree
    commits = []
    publish = tree.on_commit

    def on_commit(key, value, ts):
        commits.append((bytes(key), bytes(value), ts))
        publish(key, value, ts)

    tree.on_commit = on_commit
    for k, v, ts in _docs(3, 300):
        await tree.set_with_timestamp(k, v, ts)
    await tree.flush()
    for k, v, ts in _docs(4, 40):
        await tree.set_with_timestamp(k, v, ts + 5_000)
    return s, commits


async def _kind_frames(pkg, kind, s):
    """The frames of ``kind`` sent to ``s``; returns the responses."""
    R = PKGS[pkg].msgs.ShardRequest
    keys = [codec.packb("doc-%04d" % i) for i in (0, 5, 299, 9999)]
    if kind == "ping":
        frames = [R.ping()]
    elif kind == "telemetry_digest":
        frames = [R.telemetry_digest()]
    elif kind == "rearm":
        s.enter_degraded("disk replaced")
        frames = [R.rearm(), R.rearm()]
    elif kind == "get_metadata":
        frames = [R.get_metadata()]
    elif kind == "get_collections":
        frames = [R.create_collection("q", 2, {"ops_per_sec": 5}),
                  R.create_collection("i", 3, None, ["v", "city"]),
                  R.get_collections()]
    elif kind == "create_collection":
        frames = [R.create_collection("x", 2),
                  R.create_collection("x", 2),
                  R.create_collection("y", 1, {"bytes_per_sec": 9},
                                      ["city"])]
    elif kind == "drop_collection":
        frames = [R.drop_collection("c"), R.drop_collection("c"),
                  R.get_collections()]
    elif kind == "set":
        frames = [R.set("c", keys[3], b"\x01", 10_000),
                  R.set("c", keys[0], b"\x02", 10),  # older than flushed
                  R.set("c", keys[1], b"\x03", 20_000, 1),  # expired
                  R.get("c", keys[3]), R.get("c", keys[0])]
    elif kind == "delete":
        frames = [R.delete("c", keys[0], 20_000), R.delete("c", keys[2], 5),
                  R.delete("nope", keys[0], 1), R.get("c", keys[0]),
                  R.get("c", keys[2])]
    elif kind == "multi_set":
        entries = [[keys[0], b"\x05", 30_000], [keys[1], b"\x06", 3],
                   [keys[3], b"\x07", 30_001]]
        frames = [R.multi_set("c", entries), R.multi_get("c", keys)]
    elif kind == "multi_get":
        frames = [R.multi_get("c", keys), R.multi_get("nope", keys[:2])]
    elif kind == "get":
        frames = [R.get("c", k) for k in keys] + [R.get("nope", keys[0])]
    elif kind == "get_digest":
        frames = [R.get_digest("c", k) for k in keys]
    elif kind == "range_digest":
        frames = [R.range_digest("c", 0, 0, 8),
                  R.range_digest("c", 0x40000000, 0xC0000000, 4),
                  R.range_digest("nope", 0, 0, 2)]
    elif kind == "range_pull":
        frames = [R.range_pull("c", 0, 0, None, 50),
                  R.range_pull("c", 0x40000000, 0x10000000, keys[1], 30,
                               [0, 2], 4)]
    elif kind == "scan":
        Q = tquery if pkg == "port" else jquery
        where, agg = Q.build_spec(["cmp", "v", "<", 40], None)
        spec = Q.pack_peer_spec(where, agg, "drop")
        frames = [R.scan("c", 0, 0, None, None, 64, 4096, True),
                  R.scan("c", 0, 0, keys[1], keys[1][:5], 10, 4096, False),
                  R.scan("c", 0, 0, None, None, 1000, 1 << 20, True, spec)]
    elif kind == "watch_feed":
        boot = s.watch_plane.boot_epoch
        frames = [R.watch_feed("c", boot, 0, None, 100, 1 << 20),
                  R.watch_feed("c", boot, 300, [[0, 0x80000000]], 5, 4096)]
    else:
        assert kind == "range_push"
        entries = [[keys[0], b"\x09", 40_000], [keys[1], b"\x0a", 1],
                   [keys[3], b"\x0b", 7]]
        frames = [R.range_push("c", entries), R.get("c", keys[0]),
                  R.get("c", keys[3]), R.range_push("nope", entries)]
    out = []
    for frame in frames:
        resp = await s.handle_shard_message(frame)
        if kind == "watch_feed" and resp[1] == "watch_feed":
            resp = list(resp)
            resp[3] = "boot"
        out.append(PKGS[pkg].msgs.pack_message(resp))
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_shard_request_responses_equal(tmp_path, kind):
    """The same frames of each request kind through both packages'
    handle_shard_message: equal packed responses (error frames
    included), equal commits through on_commit (MULTI_SET fires it once
    per entry) and equal collection and degraded state after."""
    got = {}
    for pkg in ("ref", "port"):

        async def main():
            d = str(tmp_path / pkg)
            s, commits = await _seeded(pkg, d)
            n0 = len(commits)
            responses = await _kind_frames(pkg, kind, s)
            state = (sorted(s.collections), s.degraded, s.keys_healed,
                     s.governor.replica_deadline_drops,
                     sorted(os.listdir(d)))
            for t in list(s._background_tasks):
                if t is not s.governor._hb_task:
                    await asyncio.wait({t}, timeout=5)
            await shutdown(s)
            return responses, commits[n0:], state

        got[pkg] = run(main())
    assert got["port"] == got["ref"]
    responses, commits, state = got["port"]
    if kind == "multi_set":
        assert [c[2] for c in commits] == [30_000, 30_001]  # 3 is stale
    if kind == "set":
        assert state[3] == 1  # the expired frame was dropped
    if kind in ("ping", "get_metadata", "scan", "watch_feed"):
        assert all(b"error" not in r[:12] for r in responses)


# ---------------------------------------------------------------------
# Collections on disk
# ---------------------------------------------------------------------

_DDL = [("a", 1, None, None), ("b", 3, {"ops_per_sec": 7}, None),
        ("c", 2, None, ["score", "name"]),
        ("d", 2, {"bytes_per_sec": 0, "junk": 3}, ["$key", "z", "z"])]


@pytest.mark.parametrize("writer,reader", [("ref", "port"),
                                           ("port", "ref")])
def test_collection_metadata_byte_equal_across_packages(tmp_path, writer,
                                                        reader):
    """create_collection in one package writes metadata files
    byte-equal to the other's; a shard of the other package over the
    same --dir rediscovers the same (name, rf, quotas, index) tuples and
    reopens each collection."""
    files = {}
    for pkg in ("ref", "port"):

        async def create():
            d = str(tmp_path / pkg)
            s = make_shard(pkg, d)
            for name, rf, quotas, index in _DDL:
                await s.create_collection(name, rf, quotas, index)
            await shutdown(s)
            return {f: open(os.path.join(d, f), "rb").read()
                    for f in sorted(os.listdir(d)) if f.endswith(".metadata")}

        files[pkg] = run(create())
    assert files["port"] == files["ref"] and len(files["ref"]) == 4

    async def rediscover():
        s = make_shard(reader, str(tmp_path / writer))
        found = sorted(s.get_collections_from_disk())
        for name, rf, quotas, index in found:
            await s.create_collection(name, rf, quotas, index)
        cols = {n: (c.replication_factor, c.quotas, c.index_fields)
                for n, c in s.collections.items()}
        await shutdown(s)
        return found, cols

    found, cols = run(rediscover())
    assert [f[0] for f in found] == ["a", "b", "c", "d"]
    assert cols == {"a": (1, None, None), "b": (3, {"ops_per_sec": 7}, None),
                    "c": (2, None, ["name", "score"]),
                    "d": (2, {"bytes_per_sec": 0}, ["z"])}


def test_drop_collection_purges_the_same_files(tmp_path):
    """drop_collection (tree.purge) after writes and a flush leaves the
    same directory listing in both packages; the dropped name then
    answers CollectionNotFound, and a re-created collection of that
    name starts empty."""
    got = {}
    for pkg in ("ref", "port"):
        m = PKGS[pkg]

        async def main():
            d = str(tmp_path / pkg)
            s, _ = await _seeded(pkg, d)
            await s.create_collection("keep", 1)
            before = sorted(os.listdir(d))
            await s.drop_collection("c")
            after = sorted(os.listdir(d))
            with pytest.raises(m.errors.CollectionNotFound):
                await s.drop_collection("c")
            await s.create_collection("c", 1)
            empty = await s.collections["c"].tree.get_entry(
                codec.packb("doc-0001"))
            await shutdown(s)
            return before, after, empty

        got[pkg] = run(main())
    assert got["port"] == got["ref"]
    before, after, empty = got["port"]
    assert "c-0" in before and "c-0" not in after and empty is None


# ---------------------------------------------------------------------
# get_stats
# ---------------------------------------------------------------------


def test_get_stats_key_tree_equal(tmp_path):
    """get_stats after writes, a flush and one request of each data
    kind: the recursive key sets are equal, except the port's one
    extra key, each collection's ``strategy``, which names the merge and
    its device; every value outside the per-boot stamps, the
    process-wide blocks and the coalescer is equal too."""
    got = {}
    for pkg in ("ref", "port"):

        async def main():
            s, _ = await _seeded(pkg, str(tmp_path / pkg))
            await _kind_frames(pkg, "get", s)
            stats = s.get_stats()
            cluster = s.cluster_stats()
            await shutdown(s)
            return stats, cluster

        got[pkg] = run(main())
    port, ref = got["port"][0], got["ref"][0]
    assert port["collections"]["c"].pop("strategy") == "heap"
    assert key_tree(port) == key_tree(ref)
    process_wide = ("compaction", "index", "wal_group_commit",
                    "device_coalescer", "metrics", "trace", "health",
                    "telemetry", "barrier_remaining_ms")
    assert mask(port, PER_BOOT + process_wide) == \
        mask(ref, PER_BOOT + process_wide)
    assert key_tree(got["port"][1]) == key_tree(got["ref"][1])


def test_coalescer_stats_name_the_port_module_and_device(tmp_path,
                                                         monkeypatch):
    """get_stats reads the port's own coalescer for the shard's device:
    None while that module is not loaded (even with dbeel_tpu's loaded),
    its ``stats(device)`` once it is; a cpu shard's collection names
    the device strategy on cpu."""
    import dbeel_tpu.server.coalescer  # noqa: F401
    from dbeel_tpu_torch.server import coalescer

    async def main():
        s = make_shard("port", str(tmp_path), extra=(
            "--compaction-backend", "coalesced"))
        await s.create_collection("c", 1)
        monkeypatch.delitem(sys.modules, coalescer.__name__)
        absent = s.get_stats()["device_coalescer"]
        monkeypatch.setitem(sys.modules, coalescer.__name__, coalescer)
        present = s.get_stats()
        await shutdown(s)
        return absent, present

    absent, present = run(main())
    assert absent is None
    assert present["device_coalescer"] == coalescer.stats("cpu")
    assert present["device_coalescer"] is not None
    assert present["collections"]["c"]["strategy"] == "coalesced on cpu"


# ---------------------------------------------------------------------
# The device: cuda by default, cpu on request, no silent host merge
# ---------------------------------------------------------------------


def test_shard_device_default_and_cpu(tmp_path, monkeypatch):
    """MyShard builds on the card by default: without one (none here;
    on a card's host the test hides it), building a collection under
    the default backend raises and leaves no collection; device="cpu"
    merges on the kernels' plain versions."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    async def main():
        m = PKGS["port"]
        cfg = m.config.parse_args(["--dir", str(tmp_path / "a")])
        conn = m.local.LocalShardConnection(0)
        ring = [m.shard.Shard("dbeel", "dbeel-0", conn)]
        s = m.shard.MyShard(cfg, 0, ring, m.cache.PageCache(8), conn)
        assert s.device is None
        with pytest.raises(RuntimeError, match="no CUDA device"):
            await s.create_collection("c", 1)
        assert s.collections == {}
        await shutdown(s)
        cfg = cfg.replace(dir=str(tmp_path / "b"))
        conn = m.local.LocalShardConnection(0)
        ring = [m.shard.Shard("dbeel", "dbeel-0", conn)]
        s = m.shard.MyShard(cfg, 0, ring, m.cache.PageCache(8), conn,
                            device="cpu")
        await s.create_collection("c", 1)
        strategy = s.collections["c"].tree.strategy
        await shutdown(s)
        return strategy

    strategy = run(main())
    assert strategy.name == "device" and strategy.device.type == "cpu"


# ---------------------------------------------------------------------
# db_server: the envelopes MyShard arms the data plane with
# ---------------------------------------------------------------------


class _FakePlane:
    """Records what install_native_overload_responses arms."""

    def __init__(self):
        self.armed = None
        self.trace = None

    def set_overload_responses(self, shed, deadline):
        self.armed = (bytes(shed), bytes(deadline))

    def set_trace(self, on):
        self.trace = on

    def set_ownership(self, *a):
        pass


def test_native_overload_frames_byte_equal(tmp_path, monkeypatch):
    """The two overload frames armed into the data plane are
    byte-equal to the reference's; the port's MyShard arms them (and
    the trace switch) in __init__ when its data plane exists."""
    armed = {}
    for pkg in ("ref", "port"):
        s = make_shard(pkg, str(tmp_path / pkg))
        s.dataplane = _FakePlane()
        PKGS[pkg].db.install_native_overload_responses(s)
        armed[pkg] = s.dataplane.armed
        s.dataplane = None
        s.close()
    assert armed["port"] == armed["ref"]
    shed, deadline = armed["port"]
    assert int.from_bytes(shed[:4], "little") == len(shed) - 4
    assert shed[-1] == 0 and codec.unpackb(shed[4:-1])[0] == "Overloaded"

    from dbeel_tpu_torch.server import dataplane

    plane = _FakePlane()
    monkeypatch.setattr(dataplane, "create_dataplane", lambda: plane)
    s = make_shard("port", str(tmp_path / "armed"),
                   extra=("--trace-sample", "4"))
    assert s.dataplane is plane and plane.armed == armed["ref"]
    assert plane.trace is True
    s.dataplane = None
    s.close()


def test_error_and_frame_envelopes_byte_equal():
    """_error_response for every error kind and an unexpected exception,
    and _frame_response, give the reference's bytes."""
    jdb, tdb = PKGS["ref"].db, PKGS["port"].db
    errs = PKGS["port"].errors
    jerrs = PKGS["ref"].errors
    names = sorted(n for n in dir(errs)
                   if isinstance(getattr(errs, n), type)
                   and issubclass(getattr(errs, n), errs.DbeelError)
                   and hasattr(jerrs, n))
    assert len(names) > 20
    for n in names:
        try:
            e_t = getattr(errs, n)("msg é")
            e_j = getattr(jerrs, n)("msg é")
        except TypeError:
            continue
        assert tdb._error_response(e_t) == jdb._error_response(e_j)
    try:
        raise ValueError("boom")
    except ValueError as e:
        assert tdb._error_response(e) == jdb._error_response(e)
    for buf in (b"", b"\x01", bytes(range(256)) * 300):
        assert tdb._frame_response(buf) == jdb._frame_response(buf)


# ---------------------------------------------------------------------
# The five LSMTree methods the shard calls
# ---------------------------------------------------------------------

TREES = {
    "ref": lambda d, **kw: JTree.open_or_create(d, strategy=jget("heap"),
                                                **kw),
    "port": lambda d, **kw: TTree.open_or_create(
        d, strategy=tget("heap"), device="cpu", **kw),
}


def _sha_dir(d, exts=None):
    out = {}
    for f in sorted(os.listdir(d)):
        if exts is not None and f.rsplit(".", 1)[-1] not in exts:
            continue
        p = os.path.join(d, f)
        if os.path.isfile(p):
            with open(p, "rb") as fh:
                out[f] = hashlib.sha256(fh.read()).hexdigest()
        else:
            out[f] = sorted(os.listdir(p))
    return out


def test_set_batch_with_timestamp_equal(tmp_path):
    """A batch over two memtable swaps, then a stale-abort batch under
    the flush watermark: equal rejected entries, on_commit fired once
    per applied entry in the same order, equal gets, and the flushed
    tables SHA-256-equal."""
    rng = np.random.default_rng(5)
    batch = [(b"k%05d" % int(rng.integers(0, 600)), rng.bytes(12), 100 + i)
             for i in range(900)]
    got = {}
    for pkg in ("ref", "port"):

        async def main():
            d = str(tmp_path / pkg)
            tree = TREES[pkg](d, capacity=256)
            commits = []
            tree.on_commit = lambda k, v, ts: commits.append((k, ts))
            r1 = await tree.set_batch_with_timestamp(batch)
            await tree.flush()
            files = _sha_dir(d, ("data", "index", "bloom", "sums"))
            # The watermark is the wall clock at the swap: timestamps
            # around it are compared relative to it.
            wm = tree.max_flushed_ts
            stale = [(b"s%d" % i, b"v", wm - 5 + 10 * i) for i in range(4)]
            r2 = await tree.set_batch_with_timestamp(stale,
                                                     stale_abort=True)
            r2 = [(k, v, ts - wm) for k, v, ts in r2]
            commits = [(k, ts - wm if ts > wm // 2 else ts)
                       for k, ts in commits]
            gets = [await tree.get_entry(k) for k, _v, _t in batch[::37]]
            tree.close()
            return r1, r2, commits, gets, files, len(stale)

        got[pkg] = run(main())
    assert got["port"] == got["ref"]
    r1, r2, commits, _gets, files, n_stale = got["port"]
    assert r1 == [] and len(r2) == 1 and len(commits) == 900 + n_stale - 1
    assert any(f.endswith(".data") for f in files)


def test_newest_memtable_ts_equal(tmp_path):
    """Over keys in the active memtable, the flushing one, both and
    neither: equal answers, flush included."""
    got = {}
    for pkg in ("ref", "port"):

        async def main():
            tree = TREES[pkg](str(tmp_path / pkg), capacity=64)
            out = []
            for i in range(40):
                await tree.set_with_timestamp(b"a%d" % i, b"x", 10 + i)
            tree._flushing, tree._active = tree._active, tree._memtable_cls(64)
            for i in range(0, 40, 3):
                await tree.set_with_timestamp(b"a%d" % i, b"y", 5 + i * 2)
            for i in range(45):
                out.append(tree.newest_memtable_ts(b"a%d" % i))
            tree._active, tree._flushing = tree._flushing, None
            tree.close()
            return out

        got[pkg] = run(main())
    assert got["port"] == got["ref"]
    assert got["port"][3] == 13 and got["port"][44] is None


def test_finish_repair_equal(tmp_path):
    """A quarantined table, then finish_repair: the same files retired
    (quarantine/ removed), equal durability counters and suspect state,
    and recovered=False counts no repair."""
    got = {}
    for pkg in ("ref", "port"):

        async def main():
            d = str(tmp_path / pkg)
            tree = TREES[pkg](d, capacity=64)
            for i in range(200):
                await tree.set_with_timestamp(b"q%04d" % i, b"v" * 9, 7 + i)
            await tree.flush()
            out = []
            for recovered in (True, False):
                table = tree._sstables.tables[0]
                tree.quarantine_table(table, "test")
                await asyncio.gather(*list(tree._retire_tasks))
                listing = _sha_dir(d)
                suspect = tree.reads_suspect
                tree.finish_repair(tree._quarantine_pending, recovered)
                for _ in range(200):
                    if "quarantine" not in os.listdir(d):
                        break
                    await asyncio.sleep(0.01)
                out.append((listing, suspect, tree.reads_suspect,
                            dict(tree.durability), _sha_dir(d)))
            tree.close()
            return out

        got[pkg] = run(main())
    assert got["port"] == got["ref"]
    first, second = got["port"]
    assert "quarantine" in first[0] and "quarantine" not in first[4]
    assert first[1] and not first[2]
    assert first[3]["repairs_completed"] == 1
    assert second[3]["repairs_completed"] == 1


@pytest.mark.parametrize("fault", ["eio_write", "no_space"])
def test_rearm_precheck_equal(tmp_path, fault):
    """With no fault the probe passes in both packages and leaves no
    file behind; with a write fault or a full disk armed on the tree's
    directory both raise ShardDegraded with equal messages (the path
    masked)."""
    got = {}
    for pkg in ("ref", "port"):
        fio = tfile_io if pkg == "port" else jfile_io

        async def main():
            d = str(tmp_path / pkg)
            tree = TREES[pkg](d)
            await tree.rearm_precheck()
            clean = sorted(os.listdir(d))
            fio.set_fault(d, fault)
            try:
                with pytest.raises(PKGS[pkg].errors.ShardDegraded) as e:
                    await tree.rearm_precheck()
            finally:
                fio.clear_faults()
            tree.close()
            return clean, str(e.value).replace(d, "<dir>")

        got[pkg] = run(main())
    assert got["port"] == got["ref"]
    assert ".rearm-probe" not in got["port"][0]


def test_purge_equal(tmp_path):
    """purge removes the tree's directory and every cached page of its
    tables in both packages."""
    got = {}
    for pkg in ("ref", "port"):
        cache_mod = PKGS[pkg].cache

        async def main():
            d = str(tmp_path / pkg / "t")
            cache = cache_mod.PageCache(256)
            tree = TREES[pkg](d, capacity=64,
                              cache=cache_mod.PartitionPageCache("t", cache))
            for i in range(300):
                await tree.set_with_timestamp(b"p%04d" % i, b"v", 3 + i)
            await tree.flush()
            for i in range(0, 300, 7):
                await tree.get_entry(b"p%04d" % i)
            cached = len(cache)
            await tree.purge()
            return cached, len(cache), os.path.exists(d)

        got[pkg] = run(main())
    assert got["port"] == got["ref"]
    assert got["port"][0] > 0 and got["port"][1:] == (0, False)
