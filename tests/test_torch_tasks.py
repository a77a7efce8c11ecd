"""dbeel_tpu_torch.server.tasks — the shard's background tasks and its
local and remote shard servers — against dbeel_tpu.

Both packages run the same seeded writes through shards built from
``config.parse_args`` (tests/torch_shards.py; the port's with
``device="cpu"``), with short intervals set through the config, never
through sleeps in the code under test.  Peers talk over the real peer
plane: each shard binds ``bind_remote_shard_server`` on port 0.  Every
comparison is exact: table files by SHA-256, tree contents entry by
entry, responses byte for byte."""

import asyncio
import hashlib
import os

import numpy as np
import pytest

from dbeel_tpu.cluster import messages as jmsgs
from dbeel_tpu.server import scheduler as jsched
from dbeel_tpu.storage import LSMTree as JTree
from dbeel_tpu.storage.compaction import get_strategy as jget
from dbeel_tpu.storage.entry import PAGE_SIZE
from dbeel_tpu_torch.server import scheduler as tsched
from dbeel_tpu_torch.storage import LSMTree as TTree
from dbeel_tpu_torch.storage.compaction import get_strategy as tget

from torch_shards import (  # noqa: F401
    PKGS,
    link,
    make_shard,
    no_leftovers,
    reap_reference_waiters,
    run,
    serve,
    shutdown,
)

TABLE_EXTS = ("data", "index", "bloom", "sums")


def _tables(d):
    """SHA-256 of every sstable file in ``d``."""
    out = {}
    for f in sorted(os.listdir(d)):
        if f.rsplit(".", 1)[-1] in TABLE_EXTS:
            with open(os.path.join(d, f), "rb") as fh:
                out[f] = hashlib.sha256(fh.read()).hexdigest()
    return out


def _writes(seed, n, keyspace, ts0=1_000):
    rng = np.random.default_rng(seed)
    return [(b"key-%06d" % int(rng.integers(0, keyspace)),
             rng.bytes(int(rng.integers(1, 40))), ts0 + i)
            for i in range(n)]


async def _contents(tree):
    out, after = [], None
    while True:
        es, more = await tree.scan_page(0, 0, after, None, 4096, 1 << 22,
                                        True)
        out += [(bytes(k), bytes(v), int(ts)) for k, v, ts in es]
        if not more:
            return out
        after = es[-1][0]


# ---------------------------------------------------------------------
# Compaction: compact_tree under the share scheduler, and the loop
# ---------------------------------------------------------------------


TREES = {
    "ref": (lambda d: JTree.open_or_create(d, strategy=jget("heap"),
                                           capacity=1 << 16), jsched),
    "port": (lambda d: TTree.open_or_create(
        d, strategy=tget("heap"), device="cpu", capacity=1 << 16), tsched),
}


@pytest.mark.parametrize("seed", range(3))
def test_compact_tree_with_scheduler_equal(tmp_path, seed):
    """Tables of seeded sizes, then compact_tree with each package's
    ShareScheduler: the same (indices, output index, keep_tombstones)
    merges in the same order, one background unit per merge, and
    SHA-256-equal tables after."""
    rng = np.random.default_rng(seed)
    sizes = [int(x) for x in rng.choice([3, 9, 40, 130, 700], size=9)]
    got = {}
    for pkg in ("ref", "port"):
        open_tree, sched = TREES[pkg]

        async def main():
            d = str(tmp_path / pkg)
            tree = open_tree(d)
            ts = 1
            for n in sizes:
                for k, v, _ in _writes(seed * 100 + n, n, 5_000):
                    await tree.set_with_timestamp(k, v, ts)
                    ts += 1
                await tree.flush()
            merges = []
            real = tree.compact

            async def spy(indices, out, keep):
                merges.append((sorted(indices), out, keep))
                return await real(indices, out, keep)

            tree.compact = spy
            scheduler = sched.ShareScheduler(100, 50)
            await PKGS[pkg].tasks.compact_tree(tree, 2, scheduler)
            tree.close()
            return merges, scheduler.bg_units, _tables(d)

        got[pkg] = run(main())
    assert got["port"] == got["ref"]
    merges, units, tables = got["port"]
    assert merges and units == len(merges)
    assert len(tables) < 4 * len(sizes)


def test_run_compaction_loop_merges_equal_tables(tmp_path):
    """A shard whose memtable holds 64 entries, its compaction loop
    running: 12 rounds of writes, each flushed, with the loop settled
    after every flush.  Both packages leave the same merges and
    SHA-256-equal tables, fewer than the flushes, one background unit
    per merge; a collection created while the loop runs is compacted
    too."""
    got = {}
    for pkg in ("ref", "port"):
        tasks = PKGS[pkg].tasks

        async def main():
            d = str(tmp_path / pkg)
            s = make_shard(pkg, d, extra=("--memtable-capacity", "64"))
            await s.create_collection("c", 1)
            merges = []
            real = tasks.compact_tree
            busy = [0]

            async def spy(tree, factor, scheduler=None):
                busy[0] += 1
                before = [i for i, _ in tree.sstable_indices_and_sizes()]
                try:
                    await real(tree, factor, scheduler)
                finally:
                    busy[0] -= 1
                after = [i for i, _ in tree.sstable_indices_and_sizes()]
                if before != after:
                    merges.append((os.path.basename(tree.dir_path), before,
                                   after))

            tasks.compact_tree = spy
            try:
                loop = s.spawn(tasks.run_compaction_loop(s))

                async def settle():
                    for _ in range(3):
                        while busy[0]:
                            await asyncio.sleep(0.005)
                        await asyncio.sleep(0.02)

                flushes = 0
                for rnd in range(12):
                    if rnd == 6:
                        await s.create_collection("late", 1)
                        await settle()
                    for name in s.collections:
                        tree = s.collections[name].tree
                        for k, v, ts in _writes(rnd, 40, 300,
                                                ts0=10_000 * (rnd + 1)):
                            await tree.set_with_timestamp(k, v, ts)
                        await tree.flush()
                        flushes += 1
                        await settle()
                units = s.scheduler.stats()["background_units"]
                loop.cancel()
                await asyncio.gather(loop, return_exceptions=True)
                if pkg == "ref":
                    await reap_reference_waiters()
            finally:
                tasks.compact_tree = real
            tables = {n: _tables(c.tree.dir_path)
                      for n, c in s.collections.items()}
            await shutdown(s)
            return merges, tables, units, flushes

        got[pkg] = run(main())
    assert got["port"][:2] == got["ref"][:2]
    merges, tables, units, flushes = got["port"]
    n_tables = sum(len(t) for t in tables.values()) // len(TABLE_EXTS)
    assert merges and n_tables < flushes
    assert {m[0] for m in merges} == {"c-0", "late-0"}
    assert units == got["ref"][2] and units >= len(merges)


# ---------------------------------------------------------------------
# Anti-entropy, hint drain, scrub and repair between two nodes
# ---------------------------------------------------------------------


async def _pair(pkg, d, rf=2, extra=()):
    """Two one-shard nodes (n0, n1) over the peer plane, each with
    collection "c" at ``rf``."""
    a = make_shard(pkg, os.path.join(d, "n0"), "n0", extra=extra)
    b = make_shard(pkg, os.path.join(d, "n1"), "n1", extra=extra)
    servers = await link([a, b])
    for s in (a, b):
        await s.create_collection("c", rf)
    return a, b, servers


async def _wait(pred, timeout=10.0):
    deadline = asyncio.get_event_loop().time() + timeout
    while not pred():
        if asyncio.get_event_loop().time() > deadline:
            raise AssertionError("condition not reached in time")
        await asyncio.sleep(0.01)


def test_anti_entropy_round_converges_to_the_union(tmp_path):
    """Two replicas of an rf-2 collection hold diverged trees (each
    misses keys the other has, each has newer versions of some): one
    anti-entropy round of n0 leaves both trees equal to the
    newest-wins union of all writes, in both packages alike."""
    common = _writes(1, 400, 2_000)
    only_a = _writes(2, 150, 2_000, ts0=50_000)
    only_b = _writes(3, 150, 2_000, ts0=60_000)
    union = {}
    for k, v, ts in common + only_a + only_b:
        if k not in union or ts > union[k][1]:
            union[k] = (v, ts)
    want = [(k, v, ts) for k, (v, ts) in sorted(union.items())]
    got = {}
    for pkg in ("ref", "port"):
        tasks = PKGS[pkg].tasks

        async def main():
            a, b, servers = await _pair(
                pkg, str(tmp_path / pkg),
                extra=("--anti-entropy-interval", "20",
                       "--anti-entropy-buckets", "16"))
            for s, extra in ((a, only_a), (b, only_b)):
                tree = s.collections["c"].tree
                for k, v, ts in common + extra:
                    await tree.set_with_timestamp(k, v, ts)
                await tree.flush()
            loop = a.spawn(tasks.run_anti_entropy(a))
            await _wait(lambda: a.ae_rounds >= 1)
            loop.cancel()
            out = [await _contents(s.collections["c"].tree) for s in (a, b)]
            counters = (a.ae_entries_pushed, a.ae_entries_fetched,
                        a.keys_healed, b.keys_healed)
            await shutdown(a, b, servers=servers)
            return out, counters

        got[pkg] = run(main())
    assert got["port"] == got["ref"]
    (in_a, in_b), counters = got["port"]
    assert in_a == want and in_b == want
    assert counters[2] > 0 and counters[3] > 0


def test_hint_drain_replays_to_a_revived_node(tmp_path):
    """n0 writes at rf 2 while n1 is marked dead: every write becomes a
    hint, none reaches n1.  n1 revives (out of dead_nodes), and the
    hint-drain loop replays the hints: n1 then holds n0's newest entry
    of every hinted key, the hint log is empty, and both packages count
    the same replays."""
    writes = _writes(4, 120, 80, ts0=7_000)
    got = {}
    for pkg in ("ref", "port"):
        m = PKGS[pkg]

        async def main():
            a, b, servers = await _pair(
                pkg, str(tmp_path / pkg),
                extra=("--hint-drain-interval", "20"))
            a.dead_nodes.add("n1")
            R = m.msgs.ShardRequest
            tree = a.collections["c"].tree
            for k, v, ts in writes:
                await tree.set_with_timestamp(k, v, ts)
                await a.send_request_to_replicas(
                    R.set("c", k, v, ts), 1, 1, m.msgs.ShardResponse.SET,
                    key_hash=None)
            queued = a.hint_log.queued_total()
            before = await _contents(b.collections["c"].tree)
            a.dead_nodes.discard("n1")
            loop = a.spawn(m.tasks.run_hint_drain(a))
            await _wait(lambda: a.hint_log.queued_total() == 0
                        and a.hint_log.replayed > 0)
            loop.cancel()
            after = await _contents(b.collections["c"].tree)
            stats = (queued, a.hint_log.replayed, b.keys_healed)
            await shutdown(a, b, servers=servers)
            return before, after, stats

        got[pkg] = run(main())
    assert got["port"] == got["ref"]
    before, after, (queued, replayed, healed) = got["port"]
    newest = {}
    for k, v, ts in writes:
        newest[k] = (v, ts)
    assert before == [] and queued == len(newest)
    assert after == [(k, v, ts) for k, (v, ts) in sorted(newest.items())]
    assert replayed == healed == len(newest)


def test_scrub_finds_a_corrupt_page_and_repair_pulls_it_back(tmp_path):
    """Both replicas hold the same flushed table; one bit of a data page
    is flipped on n0.  n0's scrub loop finds the page, quarantines the
    table and repair_collection pulls the range back from n1: every
    key reads back on n0, the quarantine is retired, and the
    durability counters agree between packages."""
    writes = _writes(5, 600, 100_000)
    got = {}
    for pkg in ("ref", "port"):
        m = PKGS[pkg]

        async def main():
            a, b, servers = await _pair(
                pkg, str(tmp_path / pkg),
                extra=("--scrub-interval", "20",
                       "--scrub-bytes-per-sec", str(64 << 20)))
            for s in (a, b):
                tree = s.collections["c"].tree
                for k, v, ts in writes:
                    await tree.set_with_timestamp(k, v, ts)
                await tree.flush()
            tree = a.collections["c"].tree
            data = [f for f in os.listdir(tree.dir_path)
                    if f.endswith(".data")]
            assert len(data) == 1
            path = os.path.join(tree.dir_path, data[0])
            with open(path, "r+b") as f:
                f.seek(PAGE_SIZE + 100)
                byte = f.read(1)
                f.seek(PAGE_SIZE + 100)
                f.write(bytes([byte[0] ^ 0x10]))
            loop = a.spawn(m.tasks.run_scrub_loop(a))
            await _wait(lambda: tree.durability["repairs_completed"] >= 1
                        and not a._repairs_running)
            loop.cancel()
            await asyncio.gather(loop, return_exceptions=True)
            await _wait(lambda: "quarantine" not in os.listdir(
                tree.dir_path))
            gets = [await tree.get_entry(k) for k, _v, _t in writes]
            stats = a.get_stats()["durability"]
            await shutdown(a, b, servers=servers)
            return gets, stats

        got[pkg] = run(main())
    assert got["port"][0] == got["ref"][0]
    gets, stats = got["port"]
    newest = {}
    for k, v, ts in writes:
        newest[k] = (v, ts)
    assert [tuple(g) for g in gets] == [newest[k] for k, _v, _t in writes]
    ref = got["ref"][1]
    for key in ("checksum_failures", "quarantined_tables",
                "repairs_completed", "repairs_pending", "degraded_mode"):
        assert stats[key] == ref[key], key
    assert stats["quarantined_tables"] == 1
    assert stats["repairs_completed"] == 1 and stats["scrub_cycles"] >= 0


# ---------------------------------------------------------------------
# Gossip and the failure detector
# ---------------------------------------------------------------------


def test_gossip_packet_packed_by_the_reference(tmp_path):
    """A gossip datagram packed by dbeel_tpu (an ALIVE with a health
    digest, sent gossip_max_seen_count + 2 times, then a DEAD and a
    HEALTH): both packages' handle_gossip_packet leave equal nodes,
    ring, dead set, dedup counters and cluster view."""
    meta = jmsgs.NodeMetadata(
        name="n7", ip="127.0.0.1", remote_shard_base_port=1,
        ids=[0, 1], gossip_port=9, db_port=10000)
    digest = {"node": "n7", "boot": "b0", "seq": 3, "ts_ms": 5, "level": 0}
    alive = jmsgs.serialize_gossip_message(
        "n7#b0", jmsgs.GossipEvent.alive(meta), digest)
    dead = jmsgs.serialize_gossip_message(
        "n8#b1", jmsgs.GossipEvent.dead("n7"))
    health = jmsgs.serialize_gossip_message(
        "n7#b0", jmsgs.GossipEvent.health("n7", 4, dict(digest, seq=4)))
    got = {}
    for pkg in ("ref", "port"):
        m = PKGS[pkg]

        async def main():
            s = make_shard(pkg, str(tmp_path / pkg))
            steps = []
            for buf in [alive] * (s.config.gossip_max_seen_count + 2) + [
                    dead, health]:
                await m.tasks.handle_gossip_packet(s, buf)
                steps.append((
                    sorted(s.nodes), [(e.name, e.hash) for e in s.shards],
                    sorted(s.dead_nodes), sorted(s.gossip_requests.items()),
                    s.cluster_view))
            await shutdown(s)
            return steps

        got[pkg] = run(main())
    assert got["port"] == got["ref"]
    steps = got["port"]
    assert steps[0][0] == ["n7"] and steps[-2][2] == ["n7"]
    assert steps[-1][4]["n7"]["seq"] == 4


def test_failure_detector_marks_a_silent_peer_dead(tmp_path):
    """A known peer whose peer plane does not answer (a closed port):
    run_failure_detector, at a 25 ms interval set through the config,
    marks it dead and takes it off the ring within 40 intervals, in
    both packages."""
    import socket

    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    got = {}
    for pkg in ("ref", "port"):
        m = PKGS[pkg]

        async def main():
            s = make_shard(pkg, str(tmp_path / pkg), extra=(
                "--failure-detection-interval", "25"))
            peer = m.msgs.NodeMetadata(
                name="n9", ip="127.0.0.1", remote_shard_base_port=port,
                ids=[0], gossip_port=9, db_port=10000)
            s.nodes["n9"] = peer
            s.add_shards_of_nodes([peer])
            t0 = asyncio.get_event_loop().time()
            loop = s.spawn(m.tasks.run_failure_detector(s))
            await _wait(lambda: "n9" in s.dead_nodes, timeout=40 * 0.025)
            secs = asyncio.get_event_loop().time() - t0
            loop.cancel()
            state = (sorted(s.dead_nodes), sorted(s.nodes),
                     [e.name for e in s.shards], s.membership_epoch)
            await shutdown(s)
            return state, secs

        got[pkg] = run(main())
    assert got["port"][0] == got["ref"][0]
    assert got["port"][0] == (["n9"], [], ["n0-0"], 2)


# ---------------------------------------------------------------------
# The local and remote shard servers, and the stop waiter
# ---------------------------------------------------------------------


async def _exchange(port, frames, pack):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    out = []
    for frame in frames:
        payload = pack(frame)
        writer.write(len(payload).to_bytes(4, "little") + payload)
        await writer.drain()
        n = int.from_bytes(await reader.readexactly(4), "little")
        out.append(await reader.readexactly(n))
    writer.close()
    await writer.wait_closed()
    return out


def test_remote_shard_server_answers_the_same_bytes(tmp_path):
    """bind_remote_shard_server on port 0, a framed peer request of
    each family over one persistent stream (set, get, multi ops, a
    deadline-expired set, an unknown kind, a range digest): the
    response frames are byte-equal to the reference's."""
    got = {}
    for pkg in ("ref", "port"):
        m = PKGS[pkg]
        R = m.msgs.ShardRequest

        async def main():
            s = make_shard(pkg, str(tmp_path / pkg))
            await s.create_collection("c", 1)
            srv = await m.tasks.bind_remote_shard_server(s)
            port = srv.sockets[0].getsockname()[1]
            frames = [
                R.ping(), R.set("c", b"k1", b"v1", 10), R.get("c", b"k1"),
                R.multi_set("c", [[b"k2", b"v2", 11], [b"k3", b"", 12]]),
                R.multi_get("c", [b"k1", b"k2", b"k3", b"k4"]),
                R.set("c", b"k5", b"v5", 13, 1), R.get("nope", b"k1"),
                ["request", "no_such_kind"],
                R.range_digest("c", 0, 0, 4), R.get_collections(),
            ]
            out = await _exchange(port, frames, m.msgs.pack_message)
            await shutdown(s, servers=[srv])
            return out

        got[pkg] = run(main())
    assert got["port"] == got["ref"]
    assert len(got["port"]) == 10


def test_local_shard_server_and_stop_waiter(tmp_path):
    """Two shards of one node: a request to the sibling through its
    LocalShardConnection is answered by run_local_shard_server (an
    error frame for an unknown collection); stop() ends wait_for_stop
    with ShardStopped."""
    got = {}
    for pkg in ("ref", "port"):
        m = PKGS[pkg]

        async def main():
            from torch_shards import make_node

            a, b = make_node(pkg, str(tmp_path / pkg), "n0", 2)
            serve(b)
            await b.create_collection("c", 1)
            R = m.msgs.ShardRequest
            conn = b.local_connection
            out = [await conn.send_request(0, R.set("c", b"k", b"v", 9)),
                   await conn.send_request(0, R.get("c", b"k")),
                   await conn.send_request(0, R.get_digest("x", b"k")),
                   await a.send_request_to_local_shards(
                       R.ping(), m.msgs.ShardResponse.PONG)]
            waiter = asyncio.ensure_future(m.tasks.wait_for_stop(b))
            await b.stop()
            with pytest.raises(m.errors.ShardStopped):
                await waiter
            await shutdown(a, b)
            return [m.msgs.pack_message(x) if isinstance(x, list)
                    else repr(x) for x in out]

        got[pkg] = run(main())
    assert got["port"] == got["ref"]


def test_remote_shard_server_fast_path_through_the_data_plane(
        tmp_path, monkeypatch):
    """With the native data plane on (``native/`` built, an arena
    memtable), the peer plane's _try_fast answers replica sets and gets
    in C: the response
    frames over one stream are byte-equal to the reference's, the
    port's data plane counts them as native replica ops, and the
    interpreted frames between them keep their order."""
    from dbeel_tpu.storage import native as jnative
    from dbeel_tpu_torch.storage import native as tnative

    if tnative.load() is None or not jnative.native_available():
        pytest.fail("native library cannot be built")
    monkeypatch.delenv("DBEEL_NO_DATAPLANE")
    got = {}
    for pkg in ("ref", "port"):
        m = PKGS[pkg]
        R = m.msgs.ShardRequest

        async def main():
            s = make_shard(pkg, str(tmp_path / pkg),
                           extra=("--memtable-kind", "arena"))
            assert s.dataplane is not None
            await s.create_collection("c", 1)
            srv = await m.tasks.bind_remote_shard_server(s)
            port = srv.sockets[0].getsockname()[1]
            frames = [R.set("c", b"k%d" % i, b"v%d" % i, 100 + i)
                      for i in range(20)]
            frames += [R.get("c", b"k%d" % i) for i in range(0, 24, 3)]
            frames += [R.range_digest("c", 0, 0, 2), R.get("c", b"k1")]
            out = await _exchange(port, frames, m.msgs.pack_message)
            stats = s.dataplane.stats()
            await shutdown(s, servers=[srv])
            return out, stats["fast_replica_ops"]

        got[pkg] = run(main())
    assert got["port"][0] == got["ref"][0]
    assert got["port"][1] == got["ref"][1] >= 20
