"""Node bootstrap: create shards, discover the cluster, run task sets.

Role parity with the reference's main.rs:17-72 and run_shard.rs:
one shard per core (or --shards N), shard 0 is the "node managing" shard
that additionally runs the gossip server and failure detector; each
shard discovers collections (disk scan + seed query) and nodes (seed
get_metadata), announces itself via Alive gossip, then serves until a
stop event cancels the whole task set.

The reference pins one glommio executor per core; here every shard is a
cooperative task group on one asyncio loop (shared-nothing by
discipline: shards interact only through their packet queues), and a
multi-process core-pinned launcher can wrap this module per-core.

Every entry point takes ``device``: the card unless the caller passes
``"cpu"``, which runs the kernels' plain PyTorch versions.  A node whose
compaction backend merges on the card resolves its device once, on the
main thread, before any shard is built, and loads the kernel libraries
there (so no ``nvcc`` build runs on an executor thread while it
serves); without a card and without ``"cpu"`` it raises before it binds
a port.  Nothing resolves quietly to a host merge.
"""

from __future__ import annotations

import asyncio
import logging
import os
import sys
import time
from typing import List, Optional

from ..config import Config, parse_args
from ..errors import DbeelError, ShardStopped
from ..flow_events import FlowEvent
from ..cluster import messages as msgs
from ..cluster.local_comm import LocalShardConnection
from ..cluster.messages import NodeMetadata
from ..cluster.remote_comm import RemoteShardConnection
from ..storage.entry import PAGE_SIZE
from ..storage.page_cache import PageCache

# The filter stage imports torch (seconds, cold): imported here, at
# boot, so a node's first filtered scan does not stall its loop for it.
from ..storage import query_vec  # noqa: F401
from . import tasks
from .db_server import run_db_server
from .shard import MyShard, Shard

log = logging.getLogger(__name__)


def create_shard(
    config: Config,
    shard_id: int,
    connections: List[LocalShardConnection],
    device=None,
) -> MyShard:
    """run_shard.rs:174-213; the shard runs on ``device``."""
    num_shards = max(1, len(connections))
    cache = PageCache(
        max(8, config.page_cache_size // PAGE_SIZE // num_shards)
    )
    shards = [
        Shard(
            node_name=config.name,
            name=f"{config.name}-{c.id}",
            connection=c,
        )
        for c in connections
    ]
    local = next(c for c in connections if c.id == shard_id)
    return MyShard(config, shard_id, shards, cache, local, device=device)


def _discovery_candidates(my_shard: MyShard) -> list:
    """Configured seeds + persisted peers, deduped, order-preserving —
    the ONE candidate policy both discovery passes share."""
    candidates = list(my_shard.config.seed_nodes)
    for extra in _persisted_peer_seeds(my_shard):
        if extra not in candidates:
            candidates.append(extra)
    return candidates


async def discover_collections(my_shard: MyShard) -> None:
    """run_shard.rs:42-63: disk scan + seed query.

    Persisted peers serve as extra candidates and results MERGE
    across every reachable candidate, probed concurrently (same
    rationale and shape as discover_nodes): a collection created
    while this node was DOWN exists nowhere on its disk and its
    create gossip is long gone — and one reachable-but-stale seed
    must not mask a remembered peer that knows it, nor dead peers
    serialize the boot."""
    for name, rf, quotas, index in my_shard.get_collections_from_disk():
        try:
            await my_shard.create_collection(name, rf, quotas, index)
        except DbeelError:
            pass
    candidates = _discovery_candidates(my_shard)
    if not candidates:
        return

    async def _query(seed):
        conn = RemoteShardConnection.from_config(
            seed, my_shard.config
        )
        return await conn.get_collections()

    results = await asyncio.gather(
        *(_query(seed) for seed in candidates),
        return_exceptions=True,
    )
    for seed, res in zip(candidates, results):
        if isinstance(res, BaseException):
            log.error(
                "seed %s collection discovery failed: %s", seed, res
            )
            continue
        for name, rf, quotas, index in res:
            if name not in my_shard.collections:
                try:
                    await my_shard.create_collection(
                        name, rf, quotas, index
                    )
                except DbeelError:
                    pass


def _persisted_peer_seeds(my_shard: MyShard) -> list:
    """Extra discovery candidates from ``{dir}/peers.json`` (written
    by MyShard.persist_peers on every membership change) — the
    system.peers pattern: a node restarted after the cluster forgot
    it (failure detection) can re-announce via its remembered peers
    even when its configured seeds are dead or itself.  The reference
    keeps the ring only in memory and such a node stays partitioned
    alone forever (found by chaos_soak.py --scale-churn)."""
    import json as _json

    path = os.path.join(my_shard.config.dir, "peers.json")
    try:
        with open(path) as f:
            peers = [NodeMetadata.from_wire(w) for w in _json.load(f)]
    except Exception:
        # Best-effort hint file: unreadable, unparsable OR wrong-shape
        # contents (hand-edited, written by another version) must
        # never block a node boot.
        return []
    return [
        f"{p.ip}:{p.remote_shard_base_port}"
        for p in peers
        if p.name != my_shard.config.name
    ]


async def discover_nodes(my_shard: MyShard) -> None:
    """run_shard.rs:80-108: seed get_metadata → nodes map + ring.

    Deviation: the reference stops at the FIRST reachable seed; we
    merge metadata from every configured seed AND every persisted
    peer — a seed that answers with a partial view (e.g. the node's
    own half of a partition) must not mask peers that know more."""
    candidates = _discovery_candidates(my_shard)
    if not candidates:
        return

    async def _query(seed):
        conn = RemoteShardConnection.from_config(
            seed, my_shard.config
        )
        return await conn.get_metadata()

    # Probe candidates CONCURRENTLY: dead persisted peers are exactly
    # the restart-into-churn scenario this path serves, and serial
    # 5s connect timeouts would delay boot linearly with them.
    results = await asyncio.gather(
        *(_query(seed) for seed in candidates),
        return_exceptions=True,
    )
    reached = 0
    for seed, res in zip(candidates, results):
        if isinstance(res, BaseException):
            log.error("seed %s node discovery failed: %s", seed, res)
            continue
        reached += 1
        new_nodes = [
            n
            for n in res
            if n.name != my_shard.config.name
            and n.name not in my_shard.nodes
        ]
        for n in new_nodes:
            my_shard.nodes[n.name] = n
        my_shard.add_shards_of_nodes(new_nodes)
    if not reached:
        log.warning("no seed node reachable; starting standalone")
    elif my_shard.nodes:
        my_shard.persist_peers()


async def run_shard(
    my_shard: MyShard, is_node_managing: bool
) -> None:
    """run_shard.rs:110-172: discover, spawn task set, announce, serve."""
    await discover_collections(my_shard)
    await discover_nodes(my_shard)

    # Pick up migration journals a crash left behind — after discovery
    # (targets re-resolve by name against the ring we just built),
    # before serving (the resumed window's epoch fence must be up
    # before the first client write lands).
    from .migration import resume_migrations

    await resume_migrations(my_shard)

    from .db_server import bind_db_server

    # Bind listeners before declaring the shard started, so a client
    # connecting right after START_TASKS never sees refused connections.
    remote_server = await tasks.bind_remote_shard_server(my_shard)
    db_server = await bind_db_server(my_shard)

    from .db_server import reap_idle_db_connections

    coros = [
        tasks.run_remote_shard_server(my_shard, remote_server),
        tasks.run_local_shard_server(my_shard),
        tasks.run_compaction_loop(my_shard),
        run_db_server(my_shard, db_server),
        reap_idle_db_connections(my_shard),
        tasks.wait_for_stop(my_shard),
    ]
    if my_shard.config.anti_entropy_interval_ms > 0:
        coros.append(tasks.run_anti_entropy(my_shard))
    if my_shard.config.scrub_interval_ms > 0:
        coros.append(tasks.run_scrub_loop(my_shard))
    if (
        my_shard.config.hint_ttl_ms > 0
        and my_shard.config.hint_drain_interval_ms > 0
    ):
        coros.append(tasks.run_hint_drain(my_shard))
    # Continuous telemetry plane: sampling rides the governor
    # heartbeat (start() installs the hook and ensures the beat);
    # the Prometheus endpoint is its own listener task.  Both fully
    # absent when their knobs are 0.
    if my_shard.config.telemetry_interval_ms > 0:
        my_shard.telemetry.start(my_shard)
    if my_shard.config.metrics_port > 0:
        from .telemetry import run_metrics_server

        coros.append(run_metrics_server(my_shard))
    if is_node_managing:
        coros.append(tasks.run_gossip_server(my_shard))
        coros.append(tasks.run_failure_detector(my_shard))

    task_set = [asyncio.ensure_future(c) for c in coros]

    my_shard.flow.notify(FlowEvent.START_TASKS)

    # Announce ourselves (run_shard.rs:141-144).
    try:
        await my_shard.gossip(
            msgs.GossipEvent.alive(my_shard.get_node_metadata())
        )
    except Exception as e:
        log.error("alive gossip failed: %s", e)

    try:
        done, pending = await asyncio.wait(
            task_set, return_when=asyncio.FIRST_EXCEPTION
        )
        for t in done:
            exc = t.exception()
            if exc is not None and not isinstance(exc, ShardStopped):
                log.error("shard task died: %r", exc)
    finally:
        # Cancel detached per-connection handlers TOGETHER with the
        # server tasks: Server.wait_closed() (py3.12) waits for open
        # connections, so keepalive handler loops must be torn down
        # before the db-server task can finish closing.
        # Close live client transports first: py3.12's
        # Server.wait_closed() blocks until every connection is gone,
        # and protocol connections have no owning task to cancel.
        my_shard.close_db_connections()
        background = list(my_shard._background_tasks)
        # One cancel() per task is NOT enough on py<3.12:
        # asyncio.wait_for can swallow a cancellation when its inner
        # future completes in the same tick (bpo-37658), leaving the
        # task alive in its next loop iteration — the detector/AE
        # loops ping on short wait_fors constantly, so shutdown used
        # to hang on this race.  Re-cancel until everything is done.
        pending = {*task_set, *background}
        while pending:
            for t in pending:
                t.cancel()
            _done, pending = await asyncio.wait(
                pending, timeout=1.0
            )
        for t in (*task_set, *background):
            if not t.cancelled():
                t.exception()  # consume (gather(return_exceptions))
        # Announce our death (run_shard.rs:158-166) — unless this is a
        # simulated crash, which must look like the reference's
        # executor cancel: no cleanup, no goodbye.
        if is_node_managing and not my_shard.crashed:
            try:
                await my_shard.gossip(
                    msgs.GossipEvent.dead(my_shard.config.name)
                )
            except Exception:
                pass
        my_shard.close()


# The compaction backends that merge on the card (storage/compaction.py
# get_strategy): a node on one of them needs its device at boot.
DEVICE_BACKENDS = ("auto", "device", "device_full", "coalesced", "distributed")


def _resolve_node_device(config: Config, device=None):
    """The device a node's shards run on, resolved on the main thread
    before any shard is built: under a backend that merges on the card,
    ``ops._cuda.resolve_device`` (which raises without a card unless
    ``device`` is ``"cpu"``), and on ``cuda`` the kernel libraries
    loaded, each built side by side where it has no library yet.  Any
    other backend takes ``device`` as it is."""
    if config.compaction_backend not in DEVICE_BACKENDS:
        return device
    from ..ops import _cuda

    dev = _cuda.resolve_device(device)
    if dev.type == "cuda":
        _cuda.load_all()
        log.info("shards merge on %s", dev)
    return dev


def create_shard_for_process(
    config: Config, shard_id: int, total_shards: int, device=None
) -> MyShard:
    """Per-core process mode: this process hosts ONE shard; sibling
    shards of the same node appear as loopback remote ring entries."""
    cache = PageCache(
        max(8, config.page_cache_size // PAGE_SIZE // total_shards)
    )
    local = LocalShardConnection(shard_id)
    shards = []
    for i in range(total_shards):
        if i == shard_id:
            shards.append(
                Shard(
                    node_name=config.name,
                    name=f"{config.name}-{i}",
                    connection=local,
                )
            )
        else:
            shards.append(
                Shard(
                    node_name=config.name,
                    name=f"{config.name}-{i}",
                    connection=RemoteShardConnection.from_config(
                        f"{config.ip}:{config.remote_port(i)}", config
                    ),
                )
            )
    return MyShard(config, shard_id, shards, cache, local, device=device)


async def run_shard_process(
    config: Config, shard_id: int, total_shards: int, device=None
) -> None:
    """Entry for one pinned per-core process (glommio
    Placement::Fixed(cpu) analog, main.rs:48-64)."""
    try:
        os.sched_setaffinity(0, {shard_id % (os.cpu_count() or 1)})
    except (AttributeError, OSError):
        pass
    device = _resolve_node_device(config, device)
    # Same stall profiler the single-process path gets (run_node):
    # the config-5 quorum shape runs 6 shard processes + the bench,
    # and tail attribution needs the watchdog in EVERY one.
    if os.environ.get("DBEEL_LOOP_WATCHDOG") == "1":
        _start_loop_watchdog()
    my_shard = create_shard_for_process(
        config, shard_id, total_shards, device
    )
    await run_shard(my_shard, is_node_managing=shard_id == 0)


def _process_entry(
    config: Config, shard_id: int, total: int, device=None
) -> None:
    logging.basicConfig(
        level=os.environ.get("DBEEL_LOG", "INFO"),
        format=f"%(asctime)s %(levelname).1s shard{shard_id} "
        "%(name)s: %(message)s",
    )
    # Die with the parent: a SIGKILLed/terminated node process must
    # not leave shard children squatting its ports forever (observed:
    # a benched node's children outlived it by hours, holding the db
    # ports and breaking every later bind on the block).  PDEATHSIG
    # is the Linux backstop for the parent's own signal forwarding.
    try:
        import ctypes as _ct
        import signal as _sig

        _ct.CDLL(None).prctl(1, _sig.SIGTERM)  # PR_SET_PDEATHSIG
        # PDEATHSIG only fires for deaths AFTER the call: if the
        # parent died during this child's spawn bootstrap we are
        # already reparented (to init/subreaper) — exit now.
        if os.getppid() == 1:
            sys.exit(0)
    except SystemExit:
        raise
    except Exception:
        pass
    try:
        asyncio.run(run_shard_process(config, shard_id, total, device))
    except KeyboardInterrupt:
        pass


def run_node_processes(
    config: Config, num_shards: int, device=None
) -> None:
    """Spawn one OS process per shard, each pinned to a core — the
    thread-per-core deployment shape of the reference (main.rs:39-64),
    with the intra-node plane riding loopback TCP."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [
        ctx.Process(
            target=_process_entry,
            args=(config, i, num_shards, device),
            name=f"dbeel-shard-{i}",
        )
        for i in range(num_shards)
    ]
    for p in procs:
        p.start()
    # Forward SIGTERM to the children: `terminate()` on THIS process
    # (benches, service managers) must tear the whole node down, not
    # orphan the shard processes on their ports.
    import signal as _signal

    term_requested = False

    def _forward(_sig, _frm):
        nonlocal term_requested
        term_requested = True
        for p in procs:
            p.terminate()

    try:
        _signal.signal(_signal.SIGTERM, _forward)
    except ValueError:
        pass  # non-main thread: PDEATHSIG still covers the children
    try:
        for p in procs:
            p.join()
    except KeyboardInterrupt:
        for p in procs:
            p.terminate()
        for p in procs:
            p.join()
    if term_requested:
        # Operator-initiated shutdown: children exiting with
        # -SIGTERM is the CLEAN outcome, not a failure.
        return
    failed = [p.name for p in procs if p.exitcode not in (0, None)]
    if failed:
        log.error("shard processes failed: %s", failed)
        sys.exit(1)


def _start_loop_watchdog() -> None:
    """DBEEL_LOOP_WATCHDOG=1: a sampling stall profiler for the shard
    event loop.  A loop task bumps a heartbeat every 5ms; a daemon
    thread watches it and, when the loop hasn't run for >25ms,
    samples the loop thread's Python stack (sys._current_frames) to
    stderr.  If the stall is a GIL hold the sample lands right after
    release (the top frame then points at the holder); if the loop
    thread is blocked in a syscall with the GIL released, the sample
    catches the exact frame.  Diagnostic aid for tail-latency work —
    zero cost unless enabled."""
    import threading
    import traceback

    state = {"beat": time.monotonic()}
    loop_thread_id = threading.get_ident()

    async def heartbeat():
        while True:
            state["beat"] = time.monotonic()
            await asyncio.sleep(0.005)

    def watch():
        last_reported = 0.0
        while True:
            # Timed across the SLEEP only: the previous iteration's
            # stack-sample/print cost must not masquerade as
            # descheduling.
            sleep_start = time.monotonic()
            time.sleep(0.005)
            now = time.monotonic()
            # The watch thread's OWN oversleep distinguishes the two
            # stall classes: if this 5ms sleep took >25ms, the whole
            # PROCESS was descheduled (vCPU contention) — the
            # heartbeat usually wins the wake-up race and resets the
            # beat before we sample it, so without this line a
            # contention-bound host reports nothing at all (observed:
            # 556ms p999 with zero loop-stall samples on the 1-core
            # config-5 shape).
            wake_gap = now - sleep_start
            if wake_gap > 0.025:
                print(
                    f"[loopwatch] process descheduled "
                    f"{wake_gap*1e3:.0f}ms (vCPU contention)",
                    file=sys.stderr,
                    flush=True,
                )
                # The descheduling already explains a stale beat this
                # iteration; sampling the loop stack now would
                # double-count one contention event as a (spuriously
                # innocent-looking) loop stall.
                continue
            stall = now - state["beat"]
            if stall > 0.025 and now - last_reported > 0.05:
                last_reported = now
                frames = sys._current_frames()
                f = frames.get(loop_thread_id)
                stack = (
                    "".join(traceback.format_stack(f)) if f else "?"
                )
                print(
                    f"[loopwatch] loop stalled {stall*1e3:.0f}ms; "
                    f"loop thread at:\n{stack}",
                    file=sys.stderr,
                    flush=True,
                )

    asyncio.ensure_future(heartbeat())
    threading.Thread(target=watch, daemon=True).start()


async def run_node(
    config: Config, num_shards: Optional[int] = None, device=None
) -> None:
    """main.rs:17-72: one shard per core on a single loop, each on
    ``device``."""
    device = _resolve_node_device(config, device)
    if os.environ.get("DBEEL_LOOP_WATCHDOG") == "1":
        _start_loop_watchdog()
    n = num_shards or config.shards or os.cpu_count() or 1
    connections = [LocalShardConnection(i) for i in range(n)]
    shards = [
        create_shard(config, i, connections, device) for i in range(n)
    ]
    await asyncio.gather(
        *[run_shard(s, i == 0) for i, s in enumerate(shards)]
    )


def _split_device(argv):
    """``--device {cuda,cpu}`` (default ``cuda``) and the rest of the
    command line, which ``config.parse_args`` takes as it is."""
    import argparse

    parser = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ns, rest = parser.parse_known_args(
        sys.argv[1:] if argv is None else list(argv)
    )
    return ns.device, rest


def main(argv=None) -> None:
    logging.basicConfig(
        level=os.environ.get("DBEEL_LOG", "INFO"),
        format="%(asctime)s %(levelname).1s %(name)s: %(message)s",
    )
    device, argv = _split_device(argv)
    config = parse_args(argv)
    n = config.shards or os.cpu_count() or 1
    if config.processes and n > 1:
        run_node_processes(config, n, device)
        return
    try:
        asyncio.run(run_node(config, device=device))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main(sys.argv[1:])
