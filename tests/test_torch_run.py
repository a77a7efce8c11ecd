"""dbeel_tpu_torch.server.run — node bootstrap: the shard list, cluster
discovery, ``run_shard``'s task set and shutdown, the device a node
resolves, process mode and the loop watchdog — against dbeel_tpu.

Both packages build their shards from the same parsed command line
(tests/torch_shards.py ``node_config``, ports from ``port_block``; the
port's shards with ``device="cpu"``).  Every node a test starts is
stopped inside it: its tasks cancelled and awaited, its listeners
closed."""

import asyncio
import json
import os
import signal
import socket
import subprocess
import sys
import time

import msgpack
import pytest

from dbeel_tpu import errors as jerrors
from dbeel_tpu.client import DbeelClient
from dbeel_tpu_torch.storage import native as tnative

from torch_shards import (  # noqa: F401
    PKGS,
    Node,
    no_leftovers,
    node_args,
    node_config,
    port_block,
    run,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _refused(port):
    """Nothing accepts TCP connections on ``port``."""
    try:
        with socket.create_connection(("127.0.0.1", port), timeout=1):
            return False
    except OSError:
        return True


async def _accepts(port):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.close()
    await writer.wait_closed()
    return True


# ---------------------------------------------------------------------
# The shard list
# ---------------------------------------------------------------------


def _entries(my):
    """A shard's ring as (name, node, connection kind, local id or peer
    address)."""
    out = []
    for s in my.shards:
        conn = s.connection
        where = getattr(conn, "address", None) or getattr(conn, "id", None)
        out.append((s.name, s.node_name, type(conn).__name__, where))
    return out


@pytest.mark.parametrize("n_shards", [1, 3])
def test_create_shard_wiring_equal(tmp_path, n_shards):
    """``create_shard`` (one process) and ``create_shard_for_process``
    (a process a shard, siblings over loopback) build the same shard
    list in both packages; the port's shards carry their device."""
    base = port_block()
    got = {}
    for pkg, m in PKGS.items():
        cfg = node_config(pkg, str(tmp_path / pkg), base)
        conns = [m.local.LocalShardConnection(i) for i in range(n_shards)]
        shards = [m.run.create_shard(cfg, i, conns, **m.kw)
                  for i in range(n_shards)]
        shards += [m.run.create_shard_for_process(cfg, i, n_shards, **m.kw)
                   for i in range(n_shards)]
        got[pkg] = [(s.shard_name, s.id, _entries(s)) for s in shards]
        if pkg == "port":
            assert {s.device for s in shards} == {"cpu"}
        for s in shards:
            s.close()
    assert got["ref"] == got["port"]
    local = got["port"][n_shards:]
    for sid, (_name, _id, entries) in enumerate(local):
        kinds = {name: kind for name, _node, kind, _w in entries}
        assert kinds == {f"n0-{i}": "LocalShardConnection" if i == sid
                         else "RemoteShardConnection"
                         for i in range(n_shards)}


# ---------------------------------------------------------------------
# Discovery
# ---------------------------------------------------------------------


async def _discovery(pkg, d, how):
    """A seeded shard's view after discover_collections and
    discover_nodes, with a running node ``n0`` holding two collections
    as the seed (``how``: "seeds", "dead_seed" among them, or only the
    persisted "peers_json")."""
    m = PKGS[pkg]
    seed = await Node(pkg, node_config(pkg, os.path.join(d, "n0"))).start()
    try:
        client = await DbeelClient.from_seed_nodes([seed.db_address])
        await client.create_collection("x")
        await client.create_collection("y", replication_factor=1)
        dead = f"127.0.0.1:{port_block()}"
        seeds = {"seeds": [seed.seed], "dead_seed": [dead, seed.seed],
                 "peers_json": []}[how]
        cfg = node_config(pkg, os.path.join(d, "n1"), name="n1").replace(
            seed_nodes=seeds)
        os.makedirs(cfg.dir, exist_ok=True)
        if how == "peers_json":
            meta = seed.shards[0].get_node_metadata()
            with open(os.path.join(cfg.dir, "peers.json"), "w") as f:
                json.dump([meta.to_wire()], f)
        conn = m.local.LocalShardConnection(0)
        me = m.run.create_shard(cfg, 0, [conn], **m.kw)
        try:
            candidates = m.run._discovery_candidates(me)
            await m.run.discover_collections(me)
            await m.run.discover_nodes(me)
            return (candidates, sorted(me.collections),
                    sorted(me.nodes), sorted(s.name for s in me.shards))
        finally:
            me.close()
    finally:
        await seed.stop()


@pytest.mark.parametrize("how", ["seeds", "dead_seed", "peers_json"])
def test_discovery_equal(tmp_path, how):
    """A second node seeded with the first (through its seeds, a dead
    seed before the live one, or only its persisted peers.json) finds
    the same collections, nodes and ring as the reference's does."""
    got = {pkg: run(_discovery(pkg, str(tmp_path / pkg), how))
           for pkg in ("ref", "port")}
    # The candidates name each run's own ports: compared by count.
    assert got["ref"][1:] == got["port"][1:]
    assert len(got["ref"][0]) == len(got["port"][0]) == (
        2 if how == "dead_seed" else 1)
    assert got["port"][1:] == (["x", "y"], ["n0"], ["n0-0", "n1-0"])


# ---------------------------------------------------------------------
# run_shard: listeners, the task set, shutdown
# ---------------------------------------------------------------------

def _task_names(pkg_name):
    """The coroutines of the loop's tasks from the server's modules."""
    out = []
    for t in asyncio.all_tasks():
        coro = t.get_coro()
        mod = getattr(coro, "cr_frame", None)
        mod = mod.f_globals.get("__name__", "") if mod else ""
        if mod.startswith(pkg_name + ".server.") and not t.done():
            out.append(coro.__qualname__)
    return sorted(out)


async def _run_shard(pkg, d, knobs):
    m = PKGS[pkg]
    base = port_block()
    # Off: the three loops the defaults start, and no metrics or
    # telemetry; on: all five.
    extra = ("--anti-entropy-interval", "0", "--scrub-interval", "0",
             "--hint-drain-interval", "0")
    if knobs:
        extra = ("--anti-entropy-interval", "60000", "--scrub-interval",
                 "60000", "--hint-ttl", "60000", "--hint-drain-interval",
                 "60000", "--metrics-port", str(base + 12),
                 "--telemetry-interval", "60000")
    cfg = m.config.parse_args(node_args(d, base, "n0", *extra))
    node = await Node(pkg, cfg).start()
    pkg_name = "dbeel_tpu" if pkg == "ref" else "dbeel_tpu_torch"
    try:
        names = _task_names(pkg_name)
        assert await _accepts(cfg.port)
        assert await _accepts(cfg.remote_shard_port)
        if knobs:
            assert await _accepts(base + 12)
    finally:
        t0 = time.monotonic()
        await node.stop(timeout=5.0)
        took = time.monotonic() - t0
    assert took < 5.0
    assert all(t.done() for t in node.tasks)
    assert not _task_names(pkg_name)
    ports = [cfg.port, cfg.remote_shard_port] + ([base + 12] if knobs else [])
    assert all(_refused(p) for p in ports)
    return names


@pytest.mark.parametrize("knobs", [False, True])
def test_run_shard_tasks_listeners_and_stop(tmp_path, knobs):
    """After START_TASKS the db and peer listeners accept; the task set
    (with the anti-entropy, scrub, hint-drain and metrics knobs turned
    on, their tasks too) is the reference's; ``stop`` ends every task
    within 5 s and closes every listener, and no thread is left alive
    (the no_leftovers fixture)."""
    got = {pkg: run(_run_shard(pkg, str(tmp_path / pkg), knobs))
           for pkg in ("ref", "port")}
    assert got["ref"] == got["port"]
    names = set(got["port"])
    assert {"run_compaction_loop", "run_db_server", "wait_for_stop",
            "reap_idle_db_connections", "run_gossip_server",
            "run_failure_detector"} <= names
    knob_tasks = {"run_anti_entropy", "run_scrub_loop", "run_hint_drain",
                  "run_metrics_server", "LoadGovernor._heartbeat"}
    assert (knob_tasks <= names) if knobs else not (knob_tasks & names)


# ---------------------------------------------------------------------
# The device a node resolves: no fallback
# ---------------------------------------------------------------------


def test_run_node_without_a_card_raises_before_binding(tmp_path,
                                                       monkeypatch):
    """Under ``auto`` (a backend that merges on the card), ``run_node``
    with no device on a machine without a card raises before any shard
    is built or any port bound; ``main`` does the same from the
    command line, where ``--device`` defaults to cuda."""
    import torch

    from dbeel_tpu_torch.server import run as trun

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    built = []
    monkeypatch.setattr(trun, "create_shard",
                        lambda *a, **kw: built.append(a))
    base = port_block()
    args = node_args(str(tmp_path), base, "n0", "--compaction-backend",
                     "auto", "--shards", "2")
    cfg = PKGS["port"].config.parse_args(args)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        asyncio.run(trun.run_node(cfg))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trun.main(args)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trun.main(args + ["--device", "cuda"])
    assert not built
    assert all(_refused(p) for p in (base, base + 1, base + 5, base + 6))
    assert trun._split_device(args + ["--device", "cpu"]) == ("cpu", args)


@pytest.fixture(scope="module")
def native_lib():
    """The native library, built once (make -C native)."""
    return tnative.require()


async def _serve_node(tmp_path, monkeypatch, extra, device, n_keys, check):
    """run_node of the port on ``extra``'s backend; the reference
    client sets, gets and deletes over TCP, ``check(shards, stats)``
    reads what get_stats said, then every shard stops.  Returns the
    port block."""
    from dbeel_tpu_torch.server import run as trun

    shards = []
    real = trun.create_shard

    def capture(*a, **kw):
        shards.append(real(*a, **kw))
        return shards[-1]

    monkeypatch.setattr(trun, "create_shard", capture)
    base = port_block()
    cfg = PKGS["port"].config.parse_args(node_args(
        str(tmp_path), base, "n0", "--shards", "2", *extra))
    PKGS["port"].flow.enable()
    node = asyncio.ensure_future(trun.run_node(cfg, device=device))
    for _ in range(200):
        if len(shards) == 2 and not any(_refused(p) for p in (
                base, base + 1)):
            break
        await asyncio.sleep(0.05)
    try:
        client = await DbeelClient.from_seed_nodes([("127.0.0.1", base)])
        col = await client.create_collection("c")
        for i in range(n_keys):
            await col.set(f"k{i}", {"i": i})
        for i in range(n_keys):
            assert await col.get(f"k{i}") == {"i": i}
        await col.delete("k0")
        with pytest.raises(jerrors.KeyNotFound):
            await col.get("k0")
        stats = [msgpack.unpackb(await client._send_to(
            "127.0.0.1", base + i, {"type": "get_stats"}), raw=False)
            for i in range(2)]
        await check(shards, stats)
        return base
    finally:
        for s in shards:
            await s.stop()
        await asyncio.wait_for(node, 5)


def test_run_node_native_serves_without_a_card(tmp_path, monkeypatch,
                                              native_lib):
    """Under ``--compaction-backend native`` nothing merges on the card:
    ``run_node`` with no device serves on a machine without one."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    async def check(shards, stats):
        assert [s.device for s in shards] == [None, None]
        assert [st["collections"]["c"]["strategy"] for st in stats] == [
            "native", "native"]

    base = run(_serve_node(tmp_path, monkeypatch, (
        "--compaction-backend", "native"), None, 40, check))
    assert all(_refused(p) for p in (base, base + 1, base + 5, base + 6))


def test_node_round_trip_merges_on_its_device(tmp_path, monkeypatch):
    """One node, two shards on ``auto`` with ``device="cpu"``: the
    reference client's writes flush 64-entry memtables, each shard's
    compaction loop merges them on the device strategy (the kernels'
    plain versions), every get answers over TCP, and get_stats names
    "device on cpu" and carries the coalescer's stats()."""

    async def check(shards, stats):
        assert [s.device.type for s in shards] == ["cpu", "cpu"]
        for st in stats:
            assert st["collections"]["c"]["strategy"] == "device on cpu"
            # The coalescer's stats(device) once its module is loaded
            # (get_stats peeks sys.modules; this test loads nothing).
            coalescer = sys.modules.get("dbeel_tpu_torch.server.coalescer")
            assert st["device_coalescer"] == (
                coalescer.stats("cpu") if coalescer else None)
        # The ring splits the keys unevenly: the shard that flushed
        # most has merged once its tables are fewer than its flushes.
        tree = max((s.collections["c"].tree for s in shards),
                   key=lambda t: t._index)
        for _ in range(200):
            tables = tree.sstable_indices_and_sizes()
            if 0 < len(tables) < tree._index // 2:
                break
            await asyncio.sleep(0.05)
        assert 0 < len(tables) < tree._index // 2

    run(_serve_node(tmp_path, monkeypatch, (
        "--compaction-backend", "auto", "--memtable-capacity", "64"),
        "cpu", 600, check))


# ---------------------------------------------------------------------
# Process mode
# ---------------------------------------------------------------------


def _children(pid):
    out = []
    for p in os.listdir("/proc"):
        if not p.isdigit():
            continue
        try:
            with open(f"/proc/{p}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == pid:
            out.append(int(p))
    return out


def _alive(pid):
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def test_process_mode_serves_and_stops_on_sigint(tmp_path, native_lib):
    """``python -m dbeel_tpu_torch.server.run --shards 2 --processes
    --compaction-backend native --device cpu`` serves the reference
    client's set, get and delete on both shards; SIGINT ends the
    parent and both shard processes within 20 s."""
    base = port_block()
    args = node_args(str(tmp_path), base, "n0", "--shards", "2",
                     "--processes", "--compaction-backend", "native",
                     "--device", "cpu")
    proc = subprocess.Popen(
        [sys.executable, "-m", "dbeel_tpu_torch.server.run", *args],
        cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        deadline = time.monotonic() + 25
        while time.monotonic() < deadline and (
                _refused(base) or _refused(base + 1)):
            time.sleep(0.1)
        assert not _refused(base) and not _refused(base + 1)
        children = _children(proc.pid)

        async def main():
            client = await DbeelClient.from_seed_nodes(
                [("127.0.0.1", base)])
            col = await client.create_collection("pm")
            for i in range(40):
                await col.set(f"k{i}", {"i": i})
            for i in range(40):
                assert await col.get(f"k{i}") == {"i": i}
            await col.delete("k0")
            with pytest.raises(jerrors.KeyNotFound):
                await col.get("k0")
            held = [msgpack.unpackb(await client._send_to(
                "127.0.0.1", base + i, {"type": "get_stats"}),
                raw=False)["collections"]["pm"]["memtable_entries"]
                for i in range(2)]
            # The delete's tombstone takes k0's memtable slot.
            assert all(held) and sum(held) == 40

        run(main())
        shard_procs = []
        for c in children:
            with open(f"/proc/{c}/cmdline", "rb") as f:
                if b"spawn_main" in f.read():
                    shard_procs.append(c)
        assert len(shard_procs) == 2
        t0 = time.monotonic()
        proc.send_signal(signal.SIGINT)
        proc.wait(timeout=20)
        while any(_alive(c) for c in children):
            assert time.monotonic() - t0 < 20
            time.sleep(0.05)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert all(_refused(p) for p in (base, base + 1, base + 5, base + 6))


# ---------------------------------------------------------------------
# The loop watchdog
# ---------------------------------------------------------------------

_STALL = """
import asyncio, sys, tempfile, time
sys.path.insert(0, {root!r})
from {pkg} import config
from {pkg}.server import run

async def stall(shard, is_node_managing):
    await asyncio.sleep(0.05)
    time.sleep(0.3)  # the loop stalls
    await asyncio.sleep(0.1)

run.run_shard = stall
cfg = config.parse_args(["--dir", tempfile.mkdtemp(), "--shards", "1",
                         "--compaction-backend", "heap",
                         "--memtable-kind", "sorted"])
asyncio.run(run.run_node(cfg))
"""


@pytest.mark.parametrize("pkg", ["dbeel_tpu", "dbeel_tpu_torch"])
def test_loop_watchdog_reports_a_stall(pkg):
    """With ``DBEEL_LOOP_WATCHDOG=1``, run_node starts the watchdog, and
    a shard whose loop stalls for 300 ms is reported on stderr with the
    loop thread's stack, in both packages (in a child process: the
    watchdog's thread lives as long as it; its shard task here only
    stalls the loop)."""
    env = dict(os.environ, DBEEL_LOOP_WATCHDOG="1", JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", _STALL.format(root=ROOT, pkg=pkg)],
        env=env, capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert "[loopwatch] loop stalled" in out.stderr
    # The sampled stack ends in the stalling shard task.
    assert 'line 9, in stall' in out.stderr
