"""Shared set-up for the tests that hold the port's ``MyShard`` and its
shard tasks against dbeel_tpu's.

Each package's shards are built the same way from its own modules:
``config.parse_args(["--dir", d, ...])``, one ``LocalShardConnection``
per shard, a small page cache, and ``device="cpu"`` on the port (the
kernels' plain versions).  Shards of different nodes reach each other
over pooled ``RemoteShardConnection``s to the peer plane each serves on
an ephemeral port (``--remote-shard-port 0``).

The native data plane and quorum fan-out are switched off by the
``DBEEL_NO_DATAPLANE``/``DBEEL_NO_QF`` environment switches (both
packages read them at shard construction): whether ``native/`` is
built depends on which test files ran before, and the comparisons here
must not.  The governor's loop-lag heartbeat is not started, so a slow
test host cannot move the overload level between the two packages'
runs.

``run`` fails a test that leaves a task pending on its loop, and the
``no_leftovers`` fixture one that leaves a thread alive.
"""

import asyncio
import threading
import time
from types import SimpleNamespace

import pytest

from dbeel_tpu import config as jconfig
from dbeel_tpu import errors as jerrors
from dbeel_tpu.cluster import local_comm as jlocal
from dbeel_tpu.cluster import messages as jmsgs
from dbeel_tpu.cluster import remote_comm as jremote
from dbeel_tpu.server import db_server as jdb
from dbeel_tpu.server import shard as jshard
from dbeel_tpu.server import tasks as jtasks
from dbeel_tpu.storage import page_cache as jcache
from dbeel_tpu_torch import config as tconfig
from dbeel_tpu_torch import errors as terrors
from dbeel_tpu_torch.cluster import local_comm as tlocal
from dbeel_tpu_torch.cluster import messages as tmsgs
from dbeel_tpu_torch.cluster import remote_comm as tremote
from dbeel_tpu_torch.server import db_server as tdb
from dbeel_tpu_torch.server import shard as tshard
from dbeel_tpu_torch.server import tasks as ttasks
from dbeel_tpu_torch.storage import page_cache as tcache

PKGS = {
    "ref": SimpleNamespace(
        config=jconfig, errors=jerrors, local=jlocal, msgs=jmsgs,
        remote=jremote, db=jdb, shard=jshard, tasks=jtasks, cache=jcache,
        kw={}),
    "port": SimpleNamespace(
        config=tconfig, errors=terrors, local=tlocal, msgs=tmsgs,
        remote=tremote, db=tdb, shard=tshard, tasks=ttasks, cache=tcache,
        kw={"device": "cpu"}),
}

# The per-boot fields of get_stats and of the gossip source: a nonce
# and wall-clock stamps that differ between any two shards.
PER_BOOT = ("ts_ms", "uptime_s", "started_at_ms")


def shard_args(d, name="n0", *extra):
    """The command line of a test shard: a sorted memtable of 4096
    entries, the heap merge and the peer plane on an ephemeral port,
    unless ``extra`` overrides them."""
    return ["--dir", d, "--name", name, "--memtable-kind", "sorted",
            "--compaction-backend", "heap", "--memtable-capacity", "4096",
            "--remote-shard-port", "0", *extra]


def make_node(pkg, d, name="n0", n_shards=1, extra=(), **overrides):
    """The shards of one node, each holding every sibling on its ring
    (as a node's shards do in one process); ``overrides`` replace
    fields of the parsed config."""
    m = PKGS[pkg]
    cfg = m.config.parse_args(shard_args(d, name, *extra)).replace(
        **overrides)
    conns = [m.local.LocalShardConnection(i) for i in range(n_shards)]
    out = []
    for sid in range(n_shards):
        ring = [m.shard.Shard(node_name=name, name=f"{name}-{i}",
                              connection=c) for i, c in enumerate(conns)]
        s = m.shard.MyShard(cfg, sid, ring, m.cache.PageCache(64),
                            conns[sid], **m.kw)
        s.governor._hb_task = SimpleNamespace(done=lambda: False)
        out.append(s)
    return out


def make_shard(pkg, d, name="n0", extra=(), **overrides):
    return make_node(pkg, d, name, 1, extra, **overrides)[0]


def pkg_of(s):
    return PKGS["port" if isinstance(s, tshard.MyShard) else "ref"]


def metadata(s, port, gossip_port=9):
    """The node metadata of ``s``'s node as gossip carries it, its
    peer plane at ``port``; gossip goes to ``gossip_port`` (9, the
    discard port, where nothing in the tests listens)."""
    return pkg_of(s).msgs.NodeMetadata(
        name=s.config.name, ip="127.0.0.1", remote_shard_base_port=port,
        ids=[s.id], gossip_port=gossip_port, db_port=10000)


async def link(shards):
    """Each shard (one per node, built with --remote-shard-port 0)
    serves the peer plane on an ephemeral port, and learns every other
    node's shard as a pooled RemoteShardConnection ring entry, with its
    node metadata, as gossip would teach it.  Returns the servers."""
    servers, ports = [], {}
    for s in shards:
        srv = await pkg_of(s).tasks.bind_remote_shard_server(s)
        servers.append(srv)
        ports[s.shard_name] = srv.sockets[0].getsockname()[1]
    for s in shards:
        m = pkg_of(s)
        for o in shards:
            if o.config.name == s.config.name:
                continue
            port = ports[o.shard_name]
            conn = m.remote.RemoteShardConnection.from_config(
                f"127.0.0.1:{port}", s.config, pooled=True)
            s.shards.append(m.shard.Shard(
                node_name=o.config.name, name=o.shard_name,
                connection=conn))
            s.nodes[o.config.name] = metadata(o, port)
        s.sort_consistent_hash_ring()
    return servers


def serve(s):
    """Answer the shard's local queue until shutdown."""
    s.spawn(pkg_of(s).tasks.run_local_shard_server(s))


async def shutdown(*shards, servers=()):
    """Stop the peer servers, close every pooled peer stream, cancel
    and await every task the shards own, then close the shards."""
    for srv in servers:
        srv.close()
    pipes = []
    for s in shards:
        for e in list(s.shards):
            conn = e.connection
            if hasattr(conn, "close_pool"):
                pipe = getattr(conn, "_pipe", None)
                if pipe is not None and pipe.task is not None:
                    pipes.append(pipe.task)
                conn.close_pool()
    tasks = [t for s in shards for t in list(s._background_tasks)]
    for t in tasks:
        t.cancel()
    await asyncio.gather(*tasks, *pipes, return_exceptions=True)
    for s in shards:
        s.close()
    for srv in servers:
        await asyncio.wait_for(srv.wait_closed(), 5)


def run(coro, timeout=20.0):
    """Run a test coroutine on a fresh loop; fail if any task other
    than it is still pending when it returns."""

    async def main():
        result = await asyncio.wait_for(coro, timeout)
        me = asyncio.current_task()
        left = [t for t in asyncio.all_tasks()
                if t is not me and not t.done()]
        for t in left:
            t.cancel()
        assert not left, f"tasks left pending: {left}"
        return result

    return asyncio.run(main())


@pytest.fixture(autouse=True)
def no_leftovers(monkeypatch):
    """No native planes (see the module docstring); after the test, no
    thread alive that was not alive before it."""
    monkeypatch.setenv("DBEEL_NO_DATAPLANE", "1")
    monkeypatch.setenv("DBEEL_NO_QF", "1")
    before = set(threading.enumerate())
    yield
    deadline = time.monotonic() + 5.0
    while True:
        new = [t for t in threading.enumerate()
               if t not in before and t.is_alive()]
        if not new or time.monotonic() > deadline:
            break
        time.sleep(0.02)
    assert not new, f"threads left alive: {new}"


def mask(stats, keys=PER_BOOT):
    """``stats`` with the per-boot fields removed, recursively."""
    if isinstance(stats, dict):
        return {k: mask(v, keys) for k, v in stats.items() if k not in keys}
    if isinstance(stats, list):
        return [mask(v, keys) for v in stats]
    return stats


def key_tree(obj):
    """The recursive key sets of a nested dict (values dropped)."""
    if isinstance(obj, dict):
        return {k: key_tree(v) for k, v in obj.items()}
    return None
