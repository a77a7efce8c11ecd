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

Whole nodes (``Node``) run each package's ``run.run_shard`` on ports
from ``port_block``: a range of the port's tests' own, below
``tests/harness.py``'s 11000-15999 and below the ephemeral range, and
offset by the xdist worker, so no two workers and no reference test
bind the same port.
"""

import asyncio
import itertools
import os
import socket
import threading
import time
from types import SimpleNamespace

import pytest

from dbeel_tpu import config as jconfig
from dbeel_tpu import errors as jerrors
from dbeel_tpu import flow_events as jflow
from dbeel_tpu.cluster import local_comm as jlocal
from dbeel_tpu.cluster import messages as jmsgs
from dbeel_tpu.cluster import remote_comm as jremote
from dbeel_tpu.server import db_server as jdb
from dbeel_tpu.server import run as jrun
from dbeel_tpu.server import shard as jshard
from dbeel_tpu.server import tasks as jtasks
from dbeel_tpu.storage import page_cache as jcache
from dbeel_tpu.utils import event as jevent
from dbeel_tpu_torch import config as tconfig
from dbeel_tpu_torch import errors as terrors
from dbeel_tpu_torch import flow_events as tflow
from dbeel_tpu_torch.cluster import local_comm as tlocal
from dbeel_tpu_torch.cluster import messages as tmsgs
from dbeel_tpu_torch.cluster import remote_comm as tremote
from dbeel_tpu_torch.server import db_server as tdb
from dbeel_tpu_torch.server import run as trun
from dbeel_tpu_torch.server import shard as tshard
from dbeel_tpu_torch.server import tasks as ttasks
from dbeel_tpu_torch.storage import page_cache as tcache

PKGS = {
    "ref": SimpleNamespace(
        config=jconfig, errors=jerrors, local=jlocal, msgs=jmsgs,
        remote=jremote, db=jdb, shard=jshard, tasks=jtasks, cache=jcache,
        run=jrun, flow=jflow, kw={}),
    "port": SimpleNamespace(
        config=tconfig, errors=terrors, local=tlocal, msgs=tmsgs,
        remote=tremote, db=tdb, shard=tshard, tasks=ttasks, cache=tcache,
        run=trun, flow=tflow, kw={"device": "cpu"}),
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


# ---------------------------------------------------------------------
# Whole nodes on ports of their own
# ---------------------------------------------------------------------

# Worker w of the suite owns [PORT_BASE + w * PORT_SPAN, + PORT_SPAN):
# 7 workers fit below 11000, where tests/harness.py's blocks start.
PORT_BASE = 4000
PORT_SPAN = 1000
PORT_BLOCK = 16
_blocks = itertools.count()


def _bindable(port):
    """Nothing listens on ``port``, for TCP or UDP (gossip)."""
    for kind in (socket.SOCK_STREAM, socket.SOCK_DGRAM):
        with socket.socket(socket.AF_INET, kind) as sock:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            try:
                sock.bind(("127.0.0.1", port))
            except OSError:
                return False
    return True


def port_block():
    """The first port of a block of ``PORT_BLOCK`` ports, none bound.
    A worker cycles through its span, block after block, so a block
    comes back only after every other one of its span was handed out,
    and one still bound is skipped."""
    worker = os.environ.get("PYTEST_XDIST_WORKER", "gw0")
    w = int(worker[2:]) if worker[2:].isdigit() else 0
    lo = PORT_BASE + (w % 7) * PORT_SPAN
    n_blocks = PORT_SPAN // PORT_BLOCK
    for _ in range(n_blocks):
        base = lo + (next(_blocks) % n_blocks) * PORT_BLOCK
        if all(_bindable(p) for p in range(base, base + PORT_BLOCK)):
            return base
    raise RuntimeError(f"no free port block in [{lo}, {lo + PORT_SPAN})")


def node_args(d, base, name="n0", *extra):
    """A test node's command line on the block at ``base``: db ports
    from ``base``, peer ports from ``base + 5``, gossip on ``base +
    10`` (up to 5 shards); the sorted memtable of 4096 entries, the
    heap merge and no CAS boot barrier unless ``extra`` overrides
    them."""
    return ["--dir", d, "--name", name, "--port", str(base),
            "--remote-shard-port", str(base + 5),
            "--gossip-port", str(base + 10),
            "--memtable-kind", "sorted", "--compaction-backend", "heap",
            "--memtable-capacity", "4096", "--cas-boot-barrier-ms", "0",
            "--failure-detection-interval", "50", *extra]


async def reap_reference_waiters():
    """dbeel_tpu's compaction loop leaves its change waiter (a
    ``LocalEvent.wait``) pending when it is cancelled; the port's
    cancels its own.  Cancel and await the reference's."""
    waiters = [t for t in asyncio.all_tasks() if not t.done()
               and t.get_coro().cr_code.co_filename == jevent.__file__]
    for t in waiters:
        t.cancel()
    await asyncio.gather(*waiters, return_exceptions=True)


class Node:
    """Every shard of one node of package ``pkg``, each run by its
    package's ``run.run_shard`` on the current loop (the port's with
    ``device="cpu"``), as ``run_node`` runs them."""

    def __init__(self, pkg, config, n_shards=1):
        self.pkg, self.config, self.n_shards = pkg, config, n_shards
        self.shards, self.tasks = [], []

    async def start(self):
        m = PKGS[self.pkg]
        # START_TASKS is a flow event: the port's are off unless
        # enabled (the reference's conftest enables its own).
        m.flow.enable()
        conns = [m.local.LocalShardConnection(i)
                 for i in range(self.n_shards)]
        self.shards = [m.run.create_shard(self.config, i, conns, **m.kw)
                       for i in range(self.n_shards)]
        started = asyncio.ensure_future(asyncio.gather(*(
            s.flow.subscribe(m.flow.FlowEvent.START_TASKS)
            for s in self.shards)))
        self.tasks = [asyncio.ensure_future(m.run.run_shard(s, i == 0))
                      for i, s in enumerate(self.shards)]
        await asyncio.wait([started, *self.tasks],
                           return_when=asyncio.FIRST_COMPLETED)
        if not started.done():
            started.cancel()
            await self.crash()
            dead = [t for t in self.tasks if not t.cancelled()]
            raise RuntimeError("shard task died during startup") from (
                dead[0].exception() if dead else None)
        await asyncio.sleep(0)
        return self

    async def stop(self, timeout=5.0):
        """A graceful stop: every shard's stop event, then every
        run_shard awaited (its tasks cancelled, its listeners closed)."""
        for s in self.shards:
            await s.stop()
        await asyncio.wait_for(
            asyncio.gather(*self.tasks, return_exceptions=True), timeout)
        await reap_reference_waiters()

    async def crash(self):
        """Cancel without stop events: no goodbye gossip."""
        for s in self.shards:
            s.crashed = True
        for t in self.tasks:
            t.cancel()
        await asyncio.gather(*self.tasks, return_exceptions=True)
        for s in self.shards:
            s.close()
        await reap_reference_waiters()

    @property
    def db_address(self):
        return (self.config.ip, self.config.port)

    @property
    def seed(self):
        return f"{self.config.ip}:{self.config.remote_shard_port}"


def node_config(pkg, d, base=None, name="n0", extra=(), **overrides):
    """A parsed node config of package ``pkg`` (``node_args``), on a
    fresh block unless ``base`` names one."""
    base = port_block() if base is None else base
    return PKGS[pkg].config.parse_args(
        node_args(d, base, name, *extra)).replace(**overrides)
