"""Four of the reference's cluster cases, on port nodes with the port's
client, through tests/torch_shards.py's twin of tests/harness.py.

Each case body is the reference test's, written once over a package:
with ``pkg="port"`` it runs port nodes (on the CPU) and
``dbeel_tpu_torch.client``; with ``pkg="ref"`` reference nodes and
``dbeel_tpu.client``.  Both keep the reference's assertions and return
what they observed, which must equal the same expected outcome.  The
cases exercise the client's replica walk at each consistency level
(tests/test_cluster.py::test_replication_quorum_matrix), rebalancing on
a join and re-replication after a death
(tests/test_migration.py::test_node_addition_migrates_and_node_death_restores_rf),
the epoch fence's refusal and the client's resync-and-retry
(tests/test_migration.py::test_stale_epoch_write_refused_retryably_then_accepted)
and a watch cursor resumed past a killed node
(tests/test_watch.py::test_watch_kill_mid_stream_resume_zero_loss).
"""

import asyncio
from types import SimpleNamespace

import pytest

from dbeel_tpu import client as jclient
from dbeel_tpu import errors as jerrors
from dbeel_tpu.server import db_server as jdb
from dbeel_tpu_torch import client as tclient
from dbeel_tpu_torch import errors as terrors
from dbeel_tpu_torch.server import db_server as tdb

from torch_shards import (  # noqa: F401
    PKGS,
    ClusterNode,
    make_config,
    next_node_config,
    no_leftovers,
    run,
)

SIDES = {
    "ref": SimpleNamespace(client=jclient, errors=jerrors, db=jdb),
    "port": SimpleNamespace(client=tclient, errors=terrors, db=tdb),
}
N_KEYS = 60


def _flow(pkg):
    return PKGS[pkg].flow.FlowEvent


def _three_nodes(pkg, tmp_dir, **kw):
    cfg = make_config(tmp_dir, pkg, **kw)
    cfgs = [cfg]
    for i in (1, 2):
        cfgs.append(next_node_config(cfg, i, tmp_dir).replace(
            seed_nodes=[f"{cfg.ip}:{cfg.remote_shard_port}"], **kw))
    return cfgs


async def _quorum_matrix(pkg, tmp_dir):
    """tests/test_cluster.py::test_replication_quorum_matrix: RF=3,
    W=3/R=1 and W=1/R=3."""
    side, flow = SIDES[pkg], _flow(pkg)
    C = side.client.Consistency
    cfgs = _three_nodes(pkg, tmp_dir)
    nodes = [await ClusterNode(cfgs[0]).start()]
    out = []
    try:
        for c in cfgs[1:]:
            alive = nodes[0].flow_event(0, flow.ALIVE_NODE_GOSSIP)
            nodes.append(await ClusterNode(c).start())
            await alive
        client = await side.client.DbeelClient.from_seed_nodes(
            [nodes[0].db_address])
        created = [n.flow_event(0, flow.COLLECTION_CREATED) for n in nodes]
        col = await client.create_collection(
            "replicated", replication_factor=3)
        await asyncio.wait_for(asyncio.gather(*created), 10)
        out.append([("replicated" in n.shards[0].collections)
                    for n in nodes])
        await col.set("alpha", {"v": 1}, consistency=C.ALL)
        out.append(await col.get("alpha", consistency=C.fixed(1)))
        holders = 0
        for n in nodes:
            tree = n.shards[0].collections["replicated"].tree
            if await tree.get(b"\xa5alpha") is not None:
                holders += 1
        out.append(holders)
        await col.set("alpha", {"v": 2}, consistency=C.fixed(1))
        out.append(await col.get("alpha", consistency=C.ALL))
        await col.set("beta", "quorum-val", consistency=C.QUORUM)
        out.append(await col.get("beta", consistency=C.QUORUM))
        await col.delete("alpha", consistency=C.ALL)
        with pytest.raises(side.errors.KeyNotFound):
            await col.get("alpha", consistency=C.ALL)
        out.append("deleted")
        client.close()
    finally:
        for n in reversed(nodes):
            await n.stop()
    return out


async def _count_keys(node, collection):
    count = 0
    for shard in node.shards:
        col = shard.collections.get(collection)
        if col is None:
            continue
        async for _k, v, _ts in col.tree.iter():
            if v != b"":
                count += 1
    return count


async def _migration(pkg, tmp_dir):
    """tests/test_migration.py::
    test_node_addition_migrates_and_node_death_restores_rf."""
    side, flow = SIDES[pkg], _flow(pkg)
    C = side.client.Consistency
    cfg = make_config(tmp_dir, pkg)
    seed = [f"{cfg.ip}:{cfg.remote_shard_port}"]
    cfg2 = next_node_config(cfg, 1, tmp_dir).replace(seed_nodes=seed)
    cfg3 = next_node_config(cfg, 2, tmp_dir).replace(seed_nodes=seed)
    out = []
    node1 = await ClusterNode(cfg).start()
    nodes = [node1]
    clients = []
    try:
        alive = node1.flow_event(0, flow.ALIVE_NODE_GOSSIP)
        node2 = await ClusterNode(cfg2).start()
        nodes.append(node2)
        await alive
        client = await side.client.DbeelClient.from_seed_nodes(
            [node1.db_address])
        clients.append(client)
        col = await client.create_collection("m", replication_factor=2)
        for n in nodes:
            while "m" not in n.shards[0].collections:
                await asyncio.sleep(0.01)
        for i in range(N_KEYS):
            await col.set(f"key{i:03}", i, consistency=C.ALL)
        out.append([await _count_keys(n, "m") for n in nodes])
        migrations = [n.flow_event(0, flow.DONE_MIGRATION) for n in nodes]
        node3 = await ClusterNode(cfg3).start()
        nodes.append(node3)
        done, pending = await asyncio.wait(migrations, timeout=10)
        for t in pending:
            t.cancel()
        assert done, "no migration ran on node addition"
        out.append("migrated")
        while "m" not in node3.shards[0].collections:
            await asyncio.sleep(0.01)
        for _ in range(200):
            if await _count_keys(node3, "m") > 0:
                break
            await asyncio.sleep(0.02)
        assert await _count_keys(node3, "m") > 0, (
            "new node received no migrated data")
        out.append("received")
        await client.sync_metadata()
        col = client.collection("m")
        out.append([await col.get(f"key{i:03}", consistency=C.QUORUM)
                    for i in range(N_KEYS)])
        dead_seen = node3.flow_event(0, flow.DEAD_NODE_REMOVED)
        await node1.stop()
        nodes.remove(node1)
        await dead_seen
        client2 = await side.client.DbeelClient.from_seed_nodes(
            [node2.db_address])
        clients.append(client2)
        col2 = client2.collection("m")
        for _ in range(200):
            total = await _count_keys(node2, "m") + await _count_keys(
                node3, "m")
            if total >= N_KEYS:
                break
            await asyncio.sleep(0.02)
        out.append([await col2.get(f"key{i:03}", consistency=C.fixed(1))
                    for i in range(N_KEYS)])
    finally:
        for c in clients:
            c.close()
        for n in reversed(nodes):
            await n.stop()
    return out


async def _stale_epoch(pkg, tmp_dir):
    """tests/test_migration.py::
    test_stale_epoch_write_refused_retryably_then_accepted."""
    side = SIDES[pkg]
    errors = side.errors
    node = await ClusterNode(make_config(tmp_dir, pkg)).start()
    blocker = None
    out = []
    try:
        client = await side.client.DbeelClient.from_seed_nodes(
            [node.db_address])
        col = await client.create_collection("f", replication_factor=1)
        await col.set("k0", 1)
        shard = node.shards[0]
        stale = client._cluster_epoch
        assert stale == shard.membership_epoch > 0
        blocker = asyncio.ensure_future(asyncio.sleep(60))
        shard.membership_epoch += 1
        shard._migration_tasks.add(blocker)
        shard._refresh_dataplane_ownership()
        with pytest.raises(errors.KeyNotOwnedByShard) as ei:
            await side.db.handle_request(shard, {
                "type": "set", "collection": "f", "key": "k1", "value": 2,
                "epoch": stale})
        assert errors.is_retryable_class(errors.classify_error(ei.value))
        out.append(shard.fence_refusals)
        await side.db.handle_request(shard, {
            "type": "set", "collection": "f", "key": "k2", "value": 3})
        # The client's path heals itself: refusal, metadata resync (the
        # new epoch), the re-stamped retry accepted.
        await col.set("k3", 4)
        out.append(client._cluster_epoch == shard.membership_epoch)
        out.append(shard.fence_refusals)
        out.append(await col.get("k3"))
        shard._migration_tasks.discard(blocker)
        shard._refresh_dataplane_ownership()
        await side.db.handle_request(shard, {
            "type": "set", "collection": "f", "key": "k4", "value": 5,
            "epoch": stale})
        out.append(shard.fence_refusals)
        client.close()
    finally:
        if blocker is not None:
            blocker.cancel()
            await asyncio.gather(blocker, return_exceptions=True)
        await node.stop()
    return out


async def _drain_until(watcher, want, timeout_s=20.0, got=None):
    """tests/test_watch.py's: chunks until every key of ``want`` has its
    value (the newest version per key arrives), or the time is up."""
    got = {} if got is None else got
    loop = asyncio.get_event_loop()
    deadline = loop.time() + timeout_s
    while loop.time() < deadline:
        for k, v, _ts, _fl in await watcher.next_events():
            got[k] = v
        if all(got.get(k) == v for k, v in want.items()):
            return got
    return got


async def _watch_kill(pkg, tmp_dir):
    """tests/test_watch.py::test_watch_kill_mid_stream_resume_zero_loss:
    a node dies mid-stream; the subscriber keeps its cursor, walks to a
    survivor, and every acked write is delivered."""
    side = SIDES[pkg]
    cfg = make_config(tmp_dir, pkg, failure_detection_interval_ms=50)
    n0 = await ClusterNode(cfg, num_shards=1).start()
    nodes = [n0]
    client = None
    try:
        nodes.append(await ClusterNode(
            next_node_config(cfg, 1, tmp_dir), num_shards=1).start())
        nodes.append(await ClusterNode(
            next_node_config(cfg, 2, tmp_dir), num_shards=1).start())
        n1, n2 = nodes[1], nodes[2]
        client = await side.client.DbeelClient.from_seed_nodes(
            [n0.db_address, n1.db_address, n2.db_address],
            op_deadline_s=10.0)
        col = await client.create_collection("c", 3)
        w = col.watcher(wait_ms=100)
        await w.next_events()
        acked = {}
        for i in range(30):
            acked[f"pre{i}"] = {"v": i}
            await col.set(f"pre{i}", acked[f"pre{i}"])
        got = {}
        for k, v, _ts, _fl in await w.next_events():
            got[k] = v
        await n1.crash()
        nodes.remove(n1)
        for i in range(30):
            acked[f"post{i}"] = {"v": 100 + i}
            await col.set(f"post{i}", acked[f"post{i}"])
        got = await _drain_until(w, acked, timeout_s=40.0, got=got)
        missing = {k for k, v in acked.items() if got.get(k) != v}
        assert not missing, f"lost acked writes: {sorted(missing)}"
        assert w.monotonicity_violations == 0
        return [sorted(missing), w.monotonicity_violations, len(acked)]
    finally:
        if client is not None:
            client.close()
        for n in reversed(nodes):
            await n.stop()


VALUES = list(range(N_KEYS))
CASES = {
    "replication_quorum_matrix": (_quorum_matrix, [
        [True, True, True], {"v": 1}, 3, {"v": 2}, "quorum-val",
        "deleted"]),
    "node_addition_migrates_and_node_death_restores_rf": (_migration, [
        [N_KEYS, N_KEYS], "migrated", "received", VALUES, VALUES]),
    "stale_epoch_write_refused_retryably_then_accepted": (_stale_epoch, [
        1, True, 2, 4, 2]),
    "watch_kill_mid_stream_resume_zero_loss": (_watch_kill, [[], 0, 60]),
}


@pytest.mark.parametrize("pkg", ["ref", "port"])
@pytest.mark.parametrize("case", list(CASES))
def test_reference_cluster_case(tmp_path, case, pkg):
    body, want = CASES[case]
    assert run(body(pkg, str(tmp_path)), timeout=100) == want
