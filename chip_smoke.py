#!/usr/bin/env python3
"""Chip smoke test of dbeel_tpu_torch on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

(``--only kernels,mesh`` runs phase 1 and the named phases alone —
e.g. ``--only mesh`` on a host with four cards, where phase 7's
partitions take one card each, ``--only planes`` for phase 10,
which then merges its keyspace unthrottled itself, ``--only
serving`` for phase 11, ``--only node`` for phase 12 or ``--only
client`` for phase 13; ``--seed`` seeds the keys and documents of
phases 12 and 13.)

Phases (any failure exits non-zero):

  1. facts    — card name and power limit, CUDA and nvcc versions, SM
                count; builds the CUDA kernels (one nvcc per source,
                sm_90a) and the native host runtime (make -C native)
                side by side.
  2. kernels  — K1-K9b at the shapes the main path gives
                them, on adversarial data, each bit-equal to its plain
                PyTorch version on the card; K1, K2 and K3 (the merge
                path) also on edge shapes — full key ties, valid keys
                of 0xFFFFFFFF, one run holding every row, all counts 0,
                K up to 256, J = 8 with empty slots, odd out_rows; K6
                (the merge path over J jobs) on out_rows off the tile
                and 0, K of 1, 2 and 8, runs below the tile, empty jobs
                and 0xFFFFFFFF prefixes; K7 (K5's schedule on nine
                columns) on N of 8, a tile, two tiles and 2^20 with
                full key ties and a sentinel tail; K9b (which picks the
                splitters, K9a, in its own launch) on an empty bucket,
                one bucket overflowing, no and only valid rows, m and
                capacity off multiples of 4, a stack off a 16-byte
                boundary, n_dev 2, 8 and 192, and its host parts (K8c's
                sum within n * 2^-52 * sum|x| of math.fsum); K5 also at
                the mesh's final sort (524288, 9), and on edge shapes (N
                of 1 to two tiles, long runs with P > 1, the per-stage
                launches past N = tile^2/2); K4 (K5's schedule) on edge
                shapes too (K = 1, runs below, at and above the tile,
                N = 2^20), with each launch's device time as K5's;
                K8a, K8c and K8d also on odd lengths and misaligned
                views, K8c and K8d bit-identical over repeated calls and
                on two streams at once; times the
                kernel, the plain version and one library call with CUDA
                events, the kernel's own device time with torch.profiler
                and the host's time per call.
  3. compaction — bench scale: 8 runs of 1.25M docs (16 B keys, 64 B
                values, bench.py's generator recipe, seed 7) merged with
                get_strategy("device") through the pipeline (K1), plus a
                dense-cluster keyspace whose partitions keep the exact
                2-word operand (K2); SHA-256 equal to the host merge.
                The bench runs are also merged by get_strategy("native"),
                the C++ k-way merge bench.py measures against, SHA-256
                equal too; the three keys/s are logged side by side.
  4. lsm      — LSMTree write → flush → major compact → get on two
                keyspaces: diverse 8-byte prefixes (the single-shot K3
                route alone) and shared 8-byte prefixes (K3, then the
                K4 tie fallback); every get agrees with a dict oracle.
  5. shards   — one node's shards on the card: 8 LSMTrees with hash
                memtables (131072 entries) take 393216 ops each (16 B
                keys, 64 B values, seed 7); every flush sorts on the
                card (K5, 3 per shard), then each shard's size-tiered
                compaction (server/tasks.compact_tree) runs at once and
                all 8 meet in one coalesced launch (K6).  Outputs
                SHA-256-equal to the cpu merge of a copy of each
                shard's tables, a sorted-memtable twin of shard 0
                flushes the same tables, oracle gets agree.
  6. scan     — one shard's collection, filtered: 1,000,000 documents of
                blackbox_bench.py --scan-filter in one LSMTree, one major
                compaction on the card, 1% overwrites and 0.5% deletes
                left in newer tables and the memtable; then the
                selectivity sweep (a count warm-up, v < cut at 100% /
                10% / 0.1%, a 10% range), a grouped sum, a mark-mode
                pass and a keys-only scan_page pass, paged as a shard
                pages them (limit 65536, 256 KiB), each held against a
                dict oracle; the numeric leaves run on K8a (4 launches)
                and K8b (1).  Then scan_plane, the coordinator side: a
                filtered scan with a comparison leaf and a range leaf
                through ScanPlane.handle("scan"), resumed chunk by chunk
                (the default scan_bytes_per_slice) until the cursor is
                nil, and a filtered count aggregate, over the same tree,
                which a MyShard on the server's defaults holds as its
                collection: its handle_shard_request answers the SCAN
                pages; rows equal the oracle, the first spec page
                evaluates on the card (K8a and K8b) and every later one
                reuses its mask.
  7. mesh     — the distributed backend over 4 partitions placed
                round-robin on min(4, cards) cards (all on cuda:0 with
                one card): mesh_wide — BASELINE.json configs[3], one
                LSMTree (capacity 8192) takes 524288 writes of 16 B keys
                drawn from 393216 ids with msgpack values {"v", "pad"},
                64 flushed tables (~50 MB) compacted by the sample sort
                (K5 x8, K9b x4, no overflow), SHA-256 equal to
                the cpu merge of a copy, oracle gets, and K7 on the same
                columns (mesh_k7) equal to the mesh and numpy; mesh_hot —
                24 B keys with a hot 16 B prefix group, no overflow,
                equal to numpy after the long-key fix-up; mesh_skew —
                one shared first word, overflow, one fallback to K4 on
                the first partition's card, equal to numpy; mesh_big —
                phase 3's 10M docs through the mesh pipeline (K1, one
                slot per partition), SHA-256 equal to phase 3's merge.
  8. arena    — one shard as the server's defaults build it:
                LSMTree(memtable_kind="auto") resolves to the C++ arena
                memtable (asserted), 8192 entries, compaction through
                get_strategy("auto") on the card.  393216 ops (phase 5's
                recipe with 1% overwrites and 0.5% deletes) flush
                natively, each in one single-pass call (inline .sums,
                asserted by compaction_stats); the flushed tables and the
                major compaction (K3, K4 where prefixes tie) are SHA-256
                equal to a sorted-memtable twin merged by the cpu
                strategy; every key and 10000 absent ones agree with a
                dict oracle.  A durable leg: a wal_sync tree (200 us
                delay) takes 16384 writes from 64 concurrent tasks
                through the native group commit — the io_uring sync hub
                (asserted engaged wherever the host lets it create a
                ring; else the C sync thread, asserted, and the reason
                logged) — in fewer syncs than writes, and its WAL
                replays every acknowledged write after close().
  9. index    — one shard's indexed collection: 500,000 documents of
                blackbox_bench.py --scan-filter-indexed (index_fields
                ["v"], a 1 << 14-entry memtable, the write order
                shuffled from seed 7) into LSMTree(memtable_kind="auto")
                — the arena, asserted — on get_strategy("device"); every
                native flush writes a .fidx run and its sidecar
                (asserted); the flushed tables merge in tiers of 8
                (single-shot, K3 and K4), each output with a run that
                loads, the inputs' runs retired, no extra data read; the
                sweep (v < cut at 0.1%, 1% and 10%, an and of two
                leaves, a count) paged as a shard pages, each on the
                "indexed" path, byte-identical to the same tree without
                its index and equal to a dict oracle, indexed and
                scan-everything seconds side by side; 10000 cold gets
                after a reopen with an empty page cache, through io_uring
                (asserted wherever the host makes a ring; else the
                executor, asserted, and the reason logged); then one
                major compaction through the pipeline (K1), which writes
                no index run, as in dbeel_tpu, so a 0.1% scan misses the
                planner and still equals the oracle.
 10. planes   — the server's share scheduler around a merge on the card,
                as a shard wires it: config.parse_args([]) gives the
                shares (1000/250, asserted), ShareScheduler is built from
                them and the strategy's throttle is its thread_throttle();
                phase 3's dense-cluster keyspace (4 x 2^18 keys) merges
                twice through get_strategy("device"), each an executor
                unit inside bg_slice() on an event loop: idle (nothing
                marks foreground; throttled 0 s, asserted) and busy (a
                thread calls fg_mark() every 10 ms; precharged and
                throttled > 0 s, asserted).  Each output SHA-256-equal to
                phase 3's unthrottled merge, each with phase 3's launches
                (K1 x2, K2 x1); the busy/idle wall ratio is logged beside
                1 + fg/bg.
 11. serving  — one MyShard on the server's defaults
                (config.parse_args with only --dir, device "cuda"), its
                collection "c" made by create_collection: serving_dp
                feeds the arena phase's 393216 ops (16-character string
                keys, 64 B values, seed 7) as set/delete frames through
                the shard's own DataPlane.try_handle (a punt takes the
                interpreted write; each flush the flags ask for is
                spawned) while the shard's compaction loop
                (tasks.run_compaction_loop) merges every flush's size
                tier on the card (serving_loop: K3/K4 launches, fewer
                tables than flushes and background units, asserted),
                then cancels the loop, compacts the tree through
                get_strategy("auto") on the card (SHA-256-equal to the
                cpu merge of a copy), then sends a
                get frame for every key and 10000 absent ones: the
                compacted table reaches the C registry through
                write_state_listener; where the host serves
                preadv2(RWF_NOWAIT) every get is answered natively,
                elsewhere the present keys punt to the Python read
                (asserted either way) and the absent ones are answered
                natively from the bloom and prefix index; all equal the
                oracle; the shard's get_stats names the strategy on
                cuda and carries the coalescer's stats() (one line).
                serving_migrate streams a quarter of the ring
                out of the shard's collection with migrate_actions under
                its share scheduler's bg_slice into a hash-memtable tree
                on the card (65536 entries: its flush sorts on K5), which is
                then compacted on the card; it holds exactly the
                oracle's keys of the range with their timestamps, and
                the journal's last write says done.  serving_fanout runs
                10000 quorum sets (2 acks) through QuorumFanout to two
                loopback fake replicas; every op resolves with both
                acks.  Writes/s, gets/s, keys/s and ops/s are logged.
 12. node     — one node serving over TCP: the port's run_node, in this
                process, on config.parse_args with --dir, --shards 4 and
                its ports (the arena memtable of 8192 entries, auto on
                the card).  The load is a child process
                (chip_smoke.py --node-load) that imports the stdlib and
                the port's msgpack codec only and speaks the wire over 64
                keepalive connections, each frame routed to the shard
                the ring gives its key.  node_dp: create_collection
                "c", 131072 sets of 16-character keys from --seed with
                64-byte documents (about 4 flushes a shard), a get of each
                (equal to the oracle), 10000 absent keys (KeyNotFound),
                1024 deletes, each read back as KeyNotFound, a filtered
                scan and its count (scan_plane's two leaves, K8a and
                K8b) equal to the oracle, then get_stats of each shard
                (one line; "device on cuda" and the coalescer's
                stats(), asserted) while the four compaction loops
                merge on the card (K3, K4 on ties; fewer tables than
                flushes, asserted); the card's busy share over the leg
                is traced.  node_major: each shard's tables, copied after
                the node stops, major-compacted on the card, SHA-256
                equal to the cpu merge.  node_interp: a fresh node with
                DBEEL_NO_DATAPLANE=1 takes 8192 sets and 8192 gets,
                each through the interpreted path and its pure-Python
                codec.  Each node stops within 10 s and its ports then
                refuse connections.  Writes/s and gets/s of both legs,
                the punts and the merges by shard are logged.
 13. client   — the port's own clients driving a fresh 4-shard run_node
                (as phase 12's) from a child process (chip_smoke.py
                --client-load) that imports dbeel_tpu_torch.client and
                its native_client, and no JAX, dbeel_tpu or msgpack, and
                never initialises CUDA (asserted).  node_client: the C
                client (NativeDbeelClient) on collection "n": 131072
                sets of phase 12's keys and documents from --seed through
                pipe_run, a pipe_get of each (64 in flight a
                connection), every value read back by
                multi_get equal to the oracle, 10000 absent keys
                (KeyNotFound), 1024 deletes read back as KeyNotFound,
                multi_set/multi_get of 4096 keys in batches of 64, the
                filtered scan and count of phase 12 (K8a, K8b), a CAS
                conflict and commit, get_stats of each shard ("device on
                cuda"); then the async client (DbeelClient, 256 requests
                in flight) on collection "a": 32768 sets and gets,
                multi_set/multi_get of 4096 keys in 64s, a filtered scan
                and a count with a sum aggregate, cas, rmw and an atomic
                batch on one arc, a Watcher started before 1024 sets
                that sees each once and in cursor order; and one
                DbeelClientSync.get_stats.  Every answer equals the
                oracle; the node's compaction loops merge on the card
                (K3, K4 on ties); the node stops and its ports refuse
                connections.  Rates/s per client and op, the retries
                after Overloaded, the card's busy share of the leg and
                the launches are logged.

Phases 3-6, 9 and 10 run on get_strategy("device"), so their routes hold
on a host with several cards, where get_strategy("auto") is the
distributed backend (asserted: "device" on one card, "distributed" on
several).

The main path is twenty-six runs — the bench merge, the dense merge,
the two trees' major compactions, the shards' writes with their
flushes, the shards' compaction, the scan collection's compaction,
its filtered scans and its scan-plane scan, the mesh phase's
mesh_wide compaction, its K7 cross-check, mesh_hot, mesh_skew and
mesh_big, the arena tree's major compaction, the indexed collection's
tiered merges and its major compaction, the planes phase's idle and
busy throttled merges, the serving shard's compaction loop beside
its writes, its major compaction and the migration (its target's
flushes and compaction), and the node's data-plane leg (its four
compaction loops and its filtered scan), its shards' major
compactions and its interpreted leg, and the clients' node (its four
compaction loops and the clients' filtered scans and counts).  The
kernel launch
counters are zeroed just before each and read just after it, and
reported per run; phase 2's comparison launches, the cross-checks and
the traced reruns (run after their counts are read) do not count.
The line before the last is one JSON object with every kernel's
numbers; the last line is the contract line
``{"ok": true, "device": {...}}``.  It imports nothing of JAX or of
dbeel_tpu.
"""

from __future__ import annotations

import asyncio
import contextlib
import hashlib
import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".chip_smoke_work")
# Card peaks (NVIDIA H100 SXM data sheet): memory rate and the
# non-tensor 32-bit rate that integer compares run at.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
# Main-path sizes: bench.py's headline merge and the LSMTree drive.
BENCH_KEYS = 10_000_000
LSM_OPS = 500_000
# The shards phase: one node's shards (one per core) sharing one card,
# each with a 131072-entry hash memtable and the default compaction
# factor (dbeel_tpu/config.py:38), 3 memtables of ops per shard.
SHARDS = 8
SHARD_CAPACITY = 131072
SHARD_OPS = 3 * SHARD_CAPACITY
COMPACTION_FACTOR = 2
# The scan phase: one shard's collection of blackbox_bench.py
# --scan-filter documents at 10x that bench's 100,000 keys, paged as a
# shard pages a filtered scan (limit 65536, dbeel_tpu/config.py's
# scan_bytes_per_slice of 256 KiB).
SCAN_DOCS = 1_000_000
SCAN_LIMIT = 65536
SCAN_MAX_BYTES = 256 << 10
# The mesh phase: 4 partitions (the shards axis); BASELINE.json
# configs[3]'s wide merge — 64 flushes of the default 8192-entry
# memtable, 16 B keys drawn with replacement from 393216 ids so the
# tables overlap; the long-key hot-group shape of __graft_entry__.py.
MESH_PARTS = 4
WIDE_OPS = 64 * 8192
WIDE_IDS = 393_216
HOT_KEYS = 32768
SKEW_KEYS = 65536
# The arena phase: one shard as the server's defaults build it (the
# memtable "auto", dbeel_tpu/config.py:198, and 8192 entries), fed the
# shards phase's recipe; its durable leg: wal_sync with a 200 us
# coalescing delay, 64 concurrent writers.
ARENA_OPS = 3 * SHARD_CAPACITY
ARENA_DURABLE = 16384
ARENA_WRITERS = 64
# The index phase: blackbox_bench.py --scan-filter-indexed's collection
# (index_fields ["v"], a 1 << 14-entry memtable, the write order
# shuffled) at 500,000 documents (its depth cut from the scan phase's
# 1,000,000 to keep the whole run under 900 s), on the server's
# default memtable; its flushed tables are merged in size tiers of 8
# (each under the pipeline's 64 MiB, so each merge is single-shot),
# then in one major compaction (~72 MB, over 64 MiB: the pipeline;
# with far fewer documents one key-prefix group's share of a tier
# outgrows the pipeline's partitions and the merge declines).
INDEX_DOCS = 500_000
INDEX_CAPACITY = 1 << 14
INDEX_TIER = 8
INDEX_GETS = 10_000


def log(msg: str) -> None:
    print(msg, flush=True)


def sh(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True).stdout.strip()


# ----------------------------------------------------------------------
# Phase 1: facts and builds
# ----------------------------------------------------------------------


def phase_facts(torch):
    from dbeel_tpu_torch.ops import _cuda
    from dbeel_tpu_torch.storage import native

    smi = sh(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"]
    )
    log(smi.splitlines()[0] if smi else "nvidia-smi: no output")
    props = torch.cuda.get_device_properties(0)
    nvcc = sh([_cuda.nvcc_path(), "--version"]).splitlines()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"nvcc: {nvcc[-1] if nvcc else '?'}; "
        f"SMs {props.multi_processor_count}")
    # Every build starts at once: one nvcc per kernel source and make
    # for the native runtime, each on a thread.
    errors, took = [], {}
    t0 = time.perf_counter()

    def _build(name, fn):
        try:
            fn()
        except Exception as e:  # reported below
            errors.append(f"{name}: {e}")
        took[name] = time.perf_counter() - t0

    threads = [threading.Thread(target=_build, args=("native", native.build))]
    threads += [
        threading.Thread(target=_build, args=(name, lambda n=name: _cuda.build(n)))
        for name in _cuda.SOURCES
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError(f"build failed: {errors}")
    if native.load() is None:
        raise RuntimeError("native library did not load")
    _cuda.lib()
    _cuda.merge_path_lib()
    _cuda.query_lib()
    _cuda.dist_lib()
    log("build: " + ", ".join(f"{k} {v:.2f}s" for k, v in sorted(took.items()))
        + f" (all {time.perf_counter() - t0:.2f}s, side by side)")
    for name in _cuda.SOURCES:
        info = _cuda.build_info.get(name)
        if info is None:
            log(f"build {name}: cached ({_cuda.library_path(name)})")
            continue
        spills = [
            ln for ln in info["ptxas"].splitlines()
            if "spill" in ln and not ln.strip().startswith("0 bytes stack")
        ]
        log(f"build {name}: {info['seconds']:.2f}s ({info['command']}); "
            f"ptxas: {len(spills)} kernel(s) with a stack frame or spills")
    return smi.splitlines()[0] if smi else ""


# ----------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ----------------------------------------------------------------------


def _time_cuda(torch, fn, iters: int) -> float:
    """Mean ms of ``fn`` over ``iters`` launches after one warm-up,
    bracketed by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _kernel_events(torch, fn, calls: int = 20):
    """The device events of the repository's own kernels in ``calls``
    calls of ``fn`` (after one warm-up), in start order: a torch.profiler
    trace's kernels of csrc/ (their demangled names lie in the sources'
    anonymous namespace; PyTorch's own kernels, copies and fills are
    left out).  A trace whose count is not a multiple of ``calls`` lost
    events (once in a whole run, at K5's 2^19 shape) and is taken again,
    at most three times in all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        evs = sorted(
            (e for e in prof.events()
             if e.device_type == DeviceType.CUDA
             and "(anonymous namespace)::" in e.name
             and "at::" not in e.name),
            key=lambda e: e.time_range.start,
        )
        if evs and len(evs) % calls == 0:
            return evs
    raise AssertionError(f"{len(evs)} kernel events over {calls} calls")


def _kernel_name(ev):
    return ev.name.split("::", 1)[1].split("(", 1)[0]


def _device_ms(torch, fn, calls: int = 20):
    """The device time per call of the repository's own kernels in
    ``fn``, with the host out of the way: their events' device time over
    ``calls`` calls (``_kernel_events``), divided by ``calls``.  Returns
    (ms, the kernels' launches per call, their names)."""
    evs = _kernel_events(torch, fn, calls)
    us = sum(e.time_range.elapsed_us() for e in evs)
    names = sorted({_kernel_name(e) for e in evs})
    return us / calls / 1e3, len(evs) / calls, names


def _pass_profile(torch, fn, calls: int = 20):
    """The device µs of each launch of a call of ``fn`` by its place in
    the call, as [kernel, µs] (the mean over ``calls`` calls)."""
    evs = _kernel_events(torch, fn, calls)
    per = len(evs) // calls
    return [
        [_kernel_name(evs[i]),
         sum(evs[c * per + i].time_range.elapsed_us()
             for c in range(calls)) / calls]
        for i in range(per)
    ]


def _host_us(torch, fn, calls: int = 100) -> float:
    """Mean µs the host spends in one call of ``fn``: ``calls`` calls
    back to back on the host clock after one warm-up, synchronising
    only after the clock stops.  Keep calls x kernels per call well
    under the card's queue of pending launches (about a thousand):
    once it is full, each launch waits for the card and the clock reads
    device time."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    took = time.perf_counter() - t0
    torch.cuda.synchronize()
    return took / calls * 1e6


def _sorted_runs(np, rng, j, k, p, words, hi, counts, salt=0.01):
    """Sentinel-padded sorted runs: (j, k, p[, words]) u32, values
    below ``hi`` (small ``hi`` = heavy duplicates), 0xFFFFFFFF salted
    into valid rows at rate ``salt``, ``counts`` valid rows per run."""
    shape = (j, k, p) + ((words,) if words > 1 else ())
    out = np.full(shape, 0xFFFFFFFF, dtype=np.uint32)
    for jj in range(j):
        for r in range(k):
            c = int(counts[jj, r])
            v = rng.integers(0, hi, size=(c, words), dtype=np.uint64)
            v[rng.random(c) < salt, :] = 0xFFFFFFFF
            v = v[np.lexsort(v.T[::-1])] if c else v
            if words > 1:
                out[jj, r, :c] = v
            else:
                out[jj, r, :c] = v[:, 0]
    return out


def _k8_edges(torch, np, Q, rng, odd, bit_err):
    """K8a, K8c and K8d off the scan shape, on the card: odd lengths (the
    vector kernels' tails), views 1-15 elements into the values and the
    mask (the scalar path: the values off 16 B, the mask off 4 B, the
    two offsets different), every op against the salted operands; K8c
    within n * 2^-52 * sum|x| of math.fsum, bit-equal to the sum of the
    view's aligned copy, +0.0 for an empty mask and n = 0, NaN
    propagated, bit-identical over repeated calls and from two threads
    on two streams at once; K8d bit-equal to its plain version and to
    the view's aligned copy (the mask as it is, and empty), and
    bit-identical over repeated calls and on two streams."""
    dev = torch.device("cuda")
    lengths = (1, 3, 1023, 1025, 4097, (1 << 20) + 3)
    offsets = [(o, (7 * o + 3) % 16) for o in range(16)]
    base_np = rng.normal(size=lengths[-1] + 15) * 1e3
    pick = rng.random(base_np.size) < 0.3
    base_np[pick] = rng.choice(odd, size=int(pick.sum()))
    base = torch.from_numpy(base_np).to(dev)
    valid = torch.from_numpy(rng.random(base_np.size) >= 0.2).to(dev)
    finite = valid & torch.isfinite(base)
    checks = 0
    for n in (0,) + lengths:
        for ov, om in offsets:
            v, m = base[ov:ov + n], valid[om:om + n]
            if n:
                for op in Q.OPS:
                    for x in odd + [1.5, float(base_np[ov + min(7, n - 1)])]:
                        if bit_err("K8a", Q.cmp_f64(v, m, x, op),
                                   Q.cmp_f64_plain(v, m, x, op)):
                            raise AssertionError(
                                f"K8a n={n} offsets {ov},{om} {op} {x}: "
                                "masks differ")
                        checks += 1
            for mk in (m, torch.zeros_like(m)):
                mm = Q.min_max_f64(v, mk)
                if bit_err("K8d", mm, Q.min_max_f64_plain(v, mk)) or bit_err(
                        "K8d", mm, Q.min_max_f64(v.clone(), mk.clone())):
                    raise AssertionError(f"K8d n={n} offsets {ov},{om}: "
                                         "min/max differ")
            mf = finite[om:om + n] & torch.isfinite(v)
            got = Q.sum_f64(v, mf).item()
            sel = base_np[ov:ov + n][mf.cpu().numpy()]
            bound = max(n, 1) * 2.0**-52 * float(np.abs(sel).sum())
            if not abs(got - math.fsum(sel.tolist())) <= bound:
                raise AssertionError(f"K8c n={n} offsets {ov},{om}: "
                                     f"{got} off math.fsum by > {bound}")
            if Q.sum_f64(v.clone(), mf.clone()).item().hex() != got.hex():
                raise AssertionError(f"K8c n={n} offsets {ov},{om}: the "
                                     "aligned copy sums to other bits")
            empty = Q.sum_f64(v, torch.zeros_like(m)).item()
            if empty.hex() != (0.0).hex():
                raise AssertionError(f"K8c n={n}: empty mask gave {empty}")
            if n and not math.isnan(Q.sum_f64(v, m).item()) and bool(
                    torch.isnan(v[m]).any()):
                raise AssertionError(f"K8c n={n}: a NaN did not propagate")
            checks += 1
    # Bit-identical over repeated calls, and from two threads at once,
    # each on a stream (and so a scratch and ticket) of its own.
    n = SCAN_DOCS
    v, m = base[:n], finite[:n]
    want = Q.sum_f64(v, m).item().hex()
    if any(Q.sum_f64(v, m).item().hex() != want for _ in range(20)):
        raise AssertionError("K8c: repeated calls gave other bits")
    # K8d likewise, with a NaN masked in on one stream and out on the
    # other.
    mn = [valid[:n], m]

    def bits(out):
        return [x.item().hex() for x in (out if isinstance(out, tuple)
                                         else (out,))]

    want_mm = [bits(Q.min_max_f64(v, mk)) for mk in mn]
    if any(bits(Q.min_max_f64(v, mn[0])) != want_mm[0] for _ in range(20)):
        raise AssertionError("K8d: repeated calls gave other bits")
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream() for _ in range(2)]
    keys = {(torch.cuda.current_device(), s.cuda_stream) for s in streams}
    for name, calls, wants, store in (
        ("K8c", [lambda: Q.sum_f64(v, m)] * 2, [[want]] * 2, Q._sum_scratch),
        ("K8d", [lambda i=i: Q.min_max_f64(v, mn[i]) for i in range(2)],
         want_mm, Q._min_max_scratch),
    ):
        got, errors = [None, None], []

        def run(i):
            try:
                with torch.cuda.stream(streams[i]):
                    outs = [calls[i]() for _ in range(50)]
                streams[i].synchronize()
                got[i] = [bits(o) for o in outs]
            except Exception as e:  # reported below
                errors.append(e)

        threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors or any(got[i] != [wants[i]] * 50 for i in range(2)):
            raise AssertionError(
                f"{name} on two streams: {errors or 'other bits'}")
        if not keys <= set(store):
            raise AssertionError(f"{name}: two streams shared one scratch")
    log(f"K8a/K8c/K8d edges: {checks} checks over lengths 0-{lengths[-1]} "
        f"and {len(offsets)} offset pairs; K8c and K8d bit-identical over "
        f"20 calls and 2 streams x 50 calls ({want}, {want_mm})")
    # What one K8a call at the scan shape spends on the host, part by
    # part (µs per call, 2000 calls each), beside the whole call, one
    # torch.lt and the torch.cuda.Stream object the wrappers no longer
    # build.
    from dbeel_tpu_torch.ops import _cuda

    b = Q._bind()
    card = torch.cuda.current_device()
    out, stream = torch.empty_like(m), b.stream(card)

    def launch():
        b.cmp(v.data_ptr(), m.data_ptr(), n, 0.25, 2, out.data_ptr(),
              stream)

    parts = {
        "check": lambda: Q._check(v, m),
        "empty_like": lambda: torch.empty_like(m),
        "current_card": b.current,
        "raw_stream": lambda: b.stream(card),
        "ctypes_launch": launch,
        "count": lambda: _cuda.count("K8a"),
        "whole_call": lambda: Q.cmp_f64(v, m, 0.25, "<"),
        "torch_lt": lambda: torch.lt(v, 0.25),
        "stream_object": lambda: torch.cuda.current_stream().cuda_stream,
    }
    parts = {k: _host_us(torch, fn, 2000) for k, fn in parts.items()}
    log("K8a host parts (us per call): "
        + ", ".join(f"{k} {us:.3f}" for k, us in parts.items()))
    return parts


def _counts_of(np, gen, kind, j, k, p):
    """Valid rows per run, (j, k) u32, of a merge-path edge case:
    "zero" all 0, "one_run" every row in run 1 of each job, "zero_job"
    ragged with job j // 2 empty, "empty_slots" ragged with every odd
    job empty, "rand" ragged (run (0, 0) empty, the last run full)."""
    if kind == "zero":
        return np.zeros((j, k), np.uint32)
    if kind == "one_run":
        c = np.zeros((j, k), np.uint32)
        c[:, min(1, k - 1)] = p
        return c
    c = gen.integers(0, p + 1, size=(j, k)).astype(np.uint32)
    c[0, 0] = 0
    c[-1, -1] = p
    if kind == "empty_slots":
        c[1::2] = 0
    if kind == "zero_job":
        c[j // 2] = 0
    return c


def _k6_edges(torch, np, B, rng, bit_err):
    """K6 (the merge path's kTop epilogue over J > 1 jobs) off the
    main-path shape, on the card, each bit-equal to its plain version
    (the network): out_rows off the 4096-row tile, out_rows 0, K = 1
    (the epilogue alone), K = 2 (no work half), runs below the tile, a
    job whose counts are all 0, every job empty, valid prefixes of
    0xFFFFFFFF in both words (tied with the padding), K = 8 (two work
    halves) with empty jobs, one run holding every row.  Returns the
    cases' names."""
    dev = torch.device("cuda")
    T = lambda a: B.to_tensor(a, dev)  # noqa: E731
    # (name, J, K, P, hi, counts, out_rows, salt)
    cases = [
        ("out_rows_off_tile", 8, 4, 8192, 1, "rand", 5 * 4096 + 1000, 0.01),
        ("out_rows_off_tile_big", 8, 4, 32768, 2, "rand", 70001, 0.01),
        ("out_rows_0", 3, 4, 4096, 2, "rand", 0, 0.01),
        ("k1", 4, 1, 8192, 2, "rand", 8192, 0.01),
        ("k1_short", 4, 1, 4096, 2, "rand", 100, 0.01),
        ("k2", 8, 2, 8192, 1, "rand", 16384 - 3, 0.01),
        ("p_below_tile", 8, 8, 64, 3, "rand", 300, 0.01),
        ("p_8", 5, 4, 8, 2, "rand", 20, 0.01),
        ("zero_job", 8, 4, 8192, 1, "zero_job", 3 * 8192, 0.01),
        ("all_zero", 4, 4, 1024, 1, "zero", 4096, 0.01),
        ("ff_prefixes", 8, 4, 8192, 2, "rand", 20000, 0.5),
        ("k8_empty_jobs", 4, 8, 4096, 1, "empty_slots", 30000, 0.01),
        ("one_run", 2, 4, 8192, 1, "one_run", 32768, 0.01),
    ]
    names = []
    for name, j, k, p, hi, kind, out_rows, salt in cases:
        c = _counts_of(np, rng, kind, j, k, p)
        pre = T(_sorted_runs(np, rng, j, k, p, 2, hi, c, salt))
        cnt = T(c)
        if bit_err("K6", B.merge_runs_prefix_batch_kernel(pre, cnt, out_rows),
                   B.prefix_top_batch_plain(pre, cnt, out_rows)):
            raise AssertionError(f"K6 edge {name} (J={j}, K={k}, P={p}, "
                                 f"out_rows={out_rows}): differs")
        names.append(name)
    torch.cuda.synchronize()
    log(f"K6 merge-path edges: {len(names)} cases bit-equal to the network")
    return names


def _k9b_edges(torch, np, B, D, rng, bit_err):
    """K9b off the main-path data, on the card, send buffer, overflow
    word and splitters bit-equal to the plain version: an empty bucket
    (equal splitters), every valid row in one bucket (overflow), no
    valid row, no sentinel row, m and capacity not multiples of 4, the
    stack one row into its storage (the source off a 16-byte boundary),
    n_dev = 2, 8 and 192 (the pick's bitonic sort of 6144 samples).
    Each case's samples (32 copies of each splitter and of 0xFFFFFFFF,
    shuffled) are made to give its splitters.  Returns the cases'
    names."""
    dev = torch.device("cuda")
    words = np.array([0, 5, 0x7FFFFFFF, 0x80000000, 0x80000001,
                      0xC0000000, 0xFFFFFFFE, 0xFFFFFFFF], dtype=np.uint64)

    def stack(m, n_valid, k0_words):
        loc = rng.integers(0, 1 << 32, size=(m, 9), dtype=np.uint64)
        loc = loc.astype(np.uint32)
        loc[:, 0] = rng.choice(k0_words, size=m)
        loc[:, 4] = rng.integers(1, 64, size=m).astype(np.uint32)
        loc[n_valid:] = 0xFFFFFFFF
        loc[:n_valid] = loc[:n_valid][np.lexsort(loc[:n_valid, :8].T[::-1])]
        return B.to_tensor(loc, dev)

    spl4 = np.array([5, 0x80000000, 0xC0000000], np.uint32)
    m = 131072
    # (name, n_dev, local, splitters, capacity)
    cases = [
        ("empty_bucket", 4, stack(m, m - 3000, words),
         np.array([5, 5, 0x80000000], np.uint32), 65568),
        ("one_bucket_overflow", 4, stack(m, m - 100, words[3:4]), spl4,
         65568),
        ("nvalid_0", 4, stack(m, 0, words), spl4, 65568),
        ("nvalid_m", 4, stack(m, m, words), spl4, 65568),
        ("m_capacity_odd", 4, stack(m - 1, m - 2001, words), spl4, 65567),
        ("view_off_16b", 4, stack(m + 1, m - 999, words)[1:], spl4, 65569),
        ("n_dev_2", 2, stack(m, m - 3000, words),
         np.array([0x80000000], np.uint32), 131073),
        ("n_dev_8", 8, stack(m, m - 3000, words),
         np.sort(rng.choice(words, size=7)).astype(np.uint32), 32801),
        ("n_dev_192", 192, stack(m, m - 3000, words),
         np.sort(rng.choice(words, size=191)).astype(np.uint32), 1400),
    ]
    srng = np.random.default_rng(90)
    for name, n_dev, local, spl, cap in cases:
        smp = np.repeat(np.append(spl, np.uint32(0xFFFFFFFF)), 32)
        s_t = B.to_tensor(srng.permutation(smp).astype(np.uint32), dev)
        got = D.bucket_scatter_kernel(local, s_t, cap, n_dev)
        if bit_err("K9b", got, D.pick_scatter_plain(local, s_t, cap, n_dev)):
            raise AssertionError(f"K9b edge {name}: send buffers, overflow "
                                 "or splitters differ")
        if not np.array_equal(B.to_numpy(got[2]), spl):
            raise AssertionError(f"K9b edge {name}: splitters are not the "
                                 "case's")
    torch.cuda.synchronize()
    log(f"K9b edges: {len(cases)} cases bit-equal to the plain version")
    return [c[0] for c in cases]


def _k9b_host_parts(torch, D, local, smp, cap, n_dev):
    """What one K9b call at the wide shape spends on the host, part by
    part (µs per call, 500 calls each): the checks, the wrapper's three
    allocations, the device guard, the stream lookup, the ctypes launch,
    the counter and the whole call."""
    from dbeel_tpu_torch.ops import _cuda
    from dbeel_tpu_torch.ops.bitonic import _stream

    words = n_dev * cap * 9
    send = torch.empty(words + n_dev, dtype=torch.int32, device=local.device)
    fn = _cuda.dist_lib().dbeel_dist_bucket_scatter
    stream = _stream(local)

    def check():
        D._check("local", local, (local.shape[0], 9))
        D._check("samples", smp, (n_dev * 32,))
        D._device_kind(local, smp)

    def three_buffers():
        return (torch.empty((n_dev, cap, 9), dtype=torch.int32,
                            device=local.device),
                torch.empty(1, dtype=torch.int32, device=local.device),
                torch.empty(n_dev - 1, dtype=torch.int32, device=local.device))

    def guard():
        with torch.cuda.device(local.device):
            pass

    def launch():
        fn(local.data_ptr(), local.shape[0], smp.data_ptr(), n_dev, cap,
           send.data_ptr(), send.data_ptr() + words * 4,
           send.data_ptr() + (words + 1) * 4, stream)

    parts = {
        "check": check,
        "empty_three_buffers": three_buffers,
        "device_guard": guard,
        "stream": lambda: _stream(local),
        "ctypes_launch": launch,
        "count": lambda: _cuda.count("K9b"),
        "whole_call": lambda: D.bucket_scatter_kernel(local, smp, cap, n_dev),
    }
    parts = {k: _host_us(torch, f, 500) for k, f in parts.items()}
    log("K9b host parts (us per call): "
        + ", ".join(f"{k} {us:.3f}" for k, us in parts.items()))
    return parts


def _merge_path_edges(torch, np, B, rng, bit_err):
    """K1, K2 and K3 (csrc/merge_path.cu) off the main-path shapes, on
    the card, each bit-equal to its plain version (the network): every
    row tied on the key (hi = 1, so the tiles' cuts fall inside long
    equal-key stretches), half the valid keys 0xFFFFFFFF (tied with the
    padding), one run holding every row, all counts 0, K in {1, 2, 16,
    256} with their pack_bits, J = 1 and J = 8 with empty slots, runs
    shorter than a tile, a job shorter than a packed word, and out_rows
    of 1, of a non-multiple of the tile and of K*P.  K1 and K2 run the
    same cases, K1 on a generator of its own.  Returns the number of
    cases."""
    dev = torch.device("cuda")
    T = lambda a: B.to_tensor(a, dev)  # noqa: E731
    # (J, K, P, hi, counts, pack_bits or None for rid_pack_bits(K), salt)
    packed = [
        (1, 2, 8192, 1, "rand", None, 0.01),
        (1, 2, 8, 1, "rand", None, 0.01),  # 16 rows: one padded word
        (8, 16, 512, 1, "empty_slots", None, 0.01),
        (1, 256, 64, 3, "rand", None, 0.01),
        (2, 8, 4096, 2, "one_run", None, 0.01),
        (4, 8, 1024, 5, "zero", None, 0.01),
        (1, 1, 4096, 3, "rand", None, 0.01),
        (3, 4, 8, 2, "rand", 16, 0.01),
        (8, 8, 16384, 1, "empty_slots", 2, 0.01),
        (2, 8, 8192, 3, "rand", None, 0.5),  # keys tied with the padding
    ]
    cases = 0
    for name, words, gen, kernel, plain in (
        ("K2", 2, rng, B.merge_runs_prefix64_packed_batch_kernel,
         B.prefix64_packed_plain),
        ("K1", 1, np.random.default_rng(1),
         B.merge_runs_prefix32_packed_batch_kernel, B.prefix32_packed_plain),
    ):
        for j, k, p, hi, kind, pb, salt in packed:
            c = _counts_of(np, gen, kind, j, k, p)
            ops = T(_sorted_runs(np, gen, j, k, p, words, hi, c, salt))
            cnt = T(c)
            pb = pb or B.rid_pack_bits(k)
            if bit_err(name, kernel(ops, cnt, pb), plain(ops, cnt, pb)):
                raise AssertionError(
                    f"{name} edge (J={j}, K={k}, P={p}, hi={hi}, {kind}, "
                    f"pack_bits={pb}, salt={salt}): differs")
            cases += 1
    # (K, P, hi, counts, out_rows)
    top = [
        (8, 8192, 1, "rand", 1),
        (8, 8192, 1, "rand", 3000),
        (8, 8192, 1, "rand", 8 * 8192),
        (2, 4096, 2, "one_run", 2 * 4096),
        (16, 1024, 1, "zero", 5000),
        (256, 64, 3, "rand", 256 * 64),
        (1, 4096, 2, "rand", 100),
        (4, 8, 2, "rand", 32),
        (2, 8, 1, "rand", 5),
        (16, 2048, 1, "rand", 16 * 2048 - 1),
    ]
    for k, p, hi, kind, out_rows in top:
        c = _counts_of(np, rng, kind, 1, k, p)
        pre = T(_sorted_runs(np, rng, 1, k, p, 2, hi, c)[0])
        cnt = T(c[0])
        if bit_err("K3", B.merge_runs_prefix_kernel(pre, cnt, out_rows),
                   B.prefix_top_plain(pre, cnt, out_rows)):
            raise AssertionError(f"K3 edge (K={k}, P={p}, hi={hi}, {kind}, "
                                 f"out_rows={out_rows}): differs")
        cases += 1
    torch.cuda.synchronize()
    log(f"K1/K2/K3 merge-path edges: {cases} cases bit-equal to the "
        "network")
    return cases


def _expect_launches(row, want):
    """A kernel row's launches a call (torch.profiler) must be ``want``."""
    if row["device_launches_per_call"] != want:
        raise AssertionError(
            f"{row['name']}: {row['device_launches_per_call']:g} launches a "
            f"call, want {want}")


def _timings_text(t) -> str:
    plain = "" if t.get("plain_ms") is None else f" plain_ms={t['plain_ms']:.3f}"
    return (f"ms={t['ms']:.4f} device_ms={t['device_ms']:.5f} "
            f"host_us={t['host_us']:.2f}{plain} "
            f"bound_ms={t['bound_ms']:.5f} "
            f"kernels={t['device_launches_per_call']:g}x{t['device_kernels']}")


def _k5_stack(np, rng, n, real):
    """K5's operand at the flush shape (131072, 9), or a slot of the
    mesh's final sort: of n rows, half are flush rows (random 16 B keys,
    length 16, cols 5-7 zero), a quarter tie on all 8 compared words,
    the rest hold random words; col 8 is distinct; rows from ``real``
    on are sentinel rows (a memtable short of a power of two, or a
    slot's padding)."""
    st = rng.integers(0, 1 << 32, size=(n, 9), dtype=np.uint64)
    st = st.astype(np.uint32)
    st[: n // 2, 4] = 16
    st[: n // 2, 5:8] = 0
    st[n // 2: 3 * n // 4, :8] = rng.integers(
        0, 2, size=(n // 4, 8), dtype=np.uint64
    ).astype(np.uint32)
    st[:, 8] = rng.permutation(n).astype(np.uint32)
    st[real:] = 0xFFFFFFFF
    return st


def _schedule_edges(torch, np, B, rng, bit_err, name, kernel, plain, cases):
    """K5's grouped schedule (K5, or K4 with the index epilogue) off the
    main-path shapes, on the card: ``kernel`` bit-equal to ``plain``
    (the network) on stacks of ``cases`` (K, P) with full 8-word ties
    and a sentinel tail.  Returns the cases' names."""
    dev = torch.device("cuda")

    def ties(k, p):
        n = k * p
        flat = rng.integers(0, 2, size=(n, 9), dtype=np.uint64)
        flat = flat.astype(np.uint32)
        flat[:, 8] = rng.permutation(n).astype(np.uint32)
        flat[n - n // 8:] = 0xFFFFFFFF
        st = flat.reshape(k, p, 9)
        if p > 1:  # a one-row run is sorted already
            for r in range(k):
                st[r] = st[r][np.lexsort(st[r, :, :8].T[::-1])]
        return B.to_tensor(st, dev)

    names = []
    for k, p in cases:
        st = ties(k, p)
        if bit_err(name, kernel(st), plain(st)):
            raise AssertionError(f"{name} edge (K={k}, P={p}): differs")
        names.append(f"K={k} P={p}")
    torch.cuda.synchronize()
    log(f"{name} edges: {len(names)} cases bit-equal to the network")
    return names


def _k7_edges(torch, np, B, M, bit_err):
    """K7 (K5's schedule on nine columns) off the main-path shape, on
    the card, bit-equal to sort_dedup_plain: N of 8 and 1024 (the first
    launch alone reads and writes the columns), 2048 (one level past
    the tile) and 2^20 (past tile^2/2: the last level's per-stage
    launches), with 8-column ties and a sentinel tail of max(2, N/8)
    rows.  Returns the cases' names."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    names = []
    for n in (8, 1024, 2048, 1 << 20):
        c = rng.integers(0, 2, size=(9, n), dtype=np.uint64).astype(np.uint32)
        c[8] = rng.permutation(n).astype(np.uint32)
        c[:, n - max(2, n // 8):] = 0xFFFFFFFF
        cols = B.to_tensor(c, dev)
        if bit_err("K7", M.sort_dedup_kernel(cols), M.sort_dedup_plain(cols)):
            raise AssertionError(f"K7 edge N={n}: differs")
        names.append(f"N={n}")
    torch.cuda.synchronize()
    log(f"K7 edges: {len(names)} cases bit-equal to the network")
    return names


def phase_kernels(torch, np):
    from dbeel_tpu_torch.ops import bitonic as B

    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    T = lambda a: B.to_tensor(a, dev)  # noqa: E731
    results = []

    def bit_err(name, got, want):
        """Largest difference of the outputs' bits (0 = bit-equal)."""
        got_l = got if isinstance(got, tuple) else (got,)
        want_l = want if isinstance(want, tuple) else (want,)
        err = 0
        for g, w in zip(got_l, want_l):
            if g.shape != w.shape:
                raise AssertionError(f"{name}: shape {g.shape} != {w.shape}")
            if g.dtype == torch.bool:
                g, w = g.to(torch.int64), w.to(torch.int64)
            elif g.dtype == torch.float64:
                g, w = g.view(torch.int64), w.view(torch.int64)
            else:
                g, w = B._u64(g), B._u64(w)
            if g.numel():  # an empty output (out_rows 0) matches its shape
                err = max(err, int((g - w).abs().max().item()))
        return err

    def measure(kernel, plain, nbytes, ops):
        """A kernel call's times at one shape: ``ms`` (CUDA events),
        ``device_ms`` and its launches a call (torch.profiler),
        ``host_us``, the plain version's ``plain_ms`` and the bound."""
        bound_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        bound_ops = ops / PEAK_OPS_PER_S * 1e3
        device_ms, per_call, names = _device_ms(torch, kernel, 20)
        return {
            "ms": _time_cuda(torch, kernel, 20),
            "device_ms": device_ms,
            # At most ~256 launches queued (K7 and the mesh sort make 19
            # per call).
            "host_us": _host_us(
                torch, kernel, max(5, min(100, int(256 // per_call)))
            ),
            "device_kernels": names,
            "device_launches_per_call": per_call,
            "plain_ms": _time_cuda(torch, plain, 3) if plain else None,
            "bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
        }

    def record(name, fn, replaces, kernel, plain, library, nbytes, ops,
               module="bitonic", check=None, source=None, wrapper=None):
        """``check(got, want)`` returns the max abs error within its
        stated tolerance and raises outside it; default: bit-equal.
        ``source``/``wrapper`` default to csrc/<module>.cu and
        ops/<module>.py."""
        got = kernel()
        want = plain()
        torch.cuda.synchronize()
        if check is None:
            err = bit_err(name, got, want)
            if err:
                raise AssertionError(f"{name}: kernel disagrees with plain "
                                     f"(max abs err {err})")
        else:
            err = check(got, want)
        row = {
            "name": name,
            "route": "cuda",
            "source": source
            or f"dbeel_tpu_torch/csrc/{module.split('_')[0]}.cu",
            "wrapper": f"dbeel_tpu_torch/{wrapper or f'ops/{module}.py'}:{fn}",
            "replaces": replaces,
            "launches": 0,
            "bit_equal": check is None,
            "max_abs_err": err,
            **measure(kernel, plain, nbytes, ops),
            "library_ms": (
                _time_cuda(torch, library, 20) if library else None
            ),
        }
        log(f"{name}: {'bit_equal' if check is None else 'within bound'} "
            f"max_abs_err={err} {_timings_text(row)} "
            f"library_ms={row['library_ms']}")
        results.append(row)

    def as_signed(key_u64):
        """Unsigned 64-bit order as int64 order (flip the sign bit)."""
        return key_u64 ^ -(1 << 63)

    def idx_key(vals_u64, counts, k, p):
        """Sort key (value << 32 | index) — the yardstick's operand,
        built outside the timed call."""
        iota = B._index_column(B._u64(counts), k, p)
        return as_signed((vals_u64 << 32) | iota).reshape(
            vals_u64.shape[0], -1
        )

    # K1 (4, 8, 131072): the 10M-key pipeline batch.
    j, k, p = 4, 8, 131072
    counts = rng.integers(p // 2, p + 1, size=(j, k)).astype(np.uint32)
    counts[3, 5] = 0
    vals = T(_sorted_runs(np, rng, j, k, p, 1, 1 << 20, counts))
    cnt = T(counts)
    pb = B.rid_pack_bits(k)
    key1 = idx_key(B._u64(vals), cnt, k, p)
    n1 = j * k * p
    record(
        "K1", "merge_runs_prefix32_packed_batch_kernel",
        "dbeel_tpu/ops/bitonic.py:235",
        lambda: B.merge_runs_prefix32_packed_batch_kernel(vals, cnt, pb),
        lambda: B.prefix32_packed_plain(vals, cnt, pb),
        lambda: torch.sort(key1, dim=1, stable=True),
        vals.numel() * 4 + cnt.numel() * 4
        + j * B.packed_words(k, p, pb) * 4,
        n1 * (k.bit_length() - 1) * 2,
        source="dbeel_tpu_torch/csrc/merge_path.cu",
    )
    # The merge path: one launch a level.
    _expect_launches(results[-1], k.bit_length() - 1)
    del key1

    # K2 (4, 8, 131072, 2): dense-cluster partitions, exact prefixes.
    pre = T(_sorted_runs(np, rng, j, k, p, 2, 1 << 12, counts))
    key2 = B._u64(pre[..., 0]) << 32 | B._u64(pre[..., 1])
    key2 = as_signed(key2).reshape(j, -1)
    record(
        "K2", "merge_runs_prefix64_packed_batch_kernel",
        "dbeel_tpu/ops/bitonic.py:251",
        lambda: B.merge_runs_prefix64_packed_batch_kernel(pre, cnt, pb),
        lambda: B.prefix64_packed_plain(pre, cnt, pb),
        lambda: torch.sort(key2, dim=1, stable=True),
        pre.numel() * 4 + cnt.numel() * 4
        + j * B.packed_words(k, p, pb) * 4,
        n1 * (k.bit_length() - 1) * 3,
        source="dbeel_tpu_torch/csrc/merge_path.cu",
    )
    del key2, pre, vals

    # K3 (8, 2^18, 2): a single-shot merge of 8 runs.
    k, p = 8, 1 << 18
    c3 = rng.integers(p // 2, p + 1, size=(1, k)).astype(np.uint32)
    pre3 = T(_sorted_runs(np, rng, 1, k, p, 2, 1 << 16, c3)[0])
    cnt3 = T(c3[0])
    n3 = int(c3.sum())
    out_rows = min(k * p, ((n3 + 65535) >> 16) << 16)
    key3 = B._u64(pre3[..., 0]) << 32 | B._u64(pre3[..., 1])
    key3 = as_signed(key3).reshape(-1)
    record(
        "K3", "merge_runs_prefix_kernel",
        "dbeel_tpu/ops/bitonic.py:153 (and :379)",
        lambda: B.merge_runs_prefix_kernel(pre3, cnt3, out_rows),
        lambda: B.prefix_top_plain(pre3, cnt3, out_rows),
        lambda: torch.sort(key3, stable=True),
        pre3.numel() * 4 + cnt3.numel() * 4 + out_rows * 4,
        k * p * (k.bit_length() - 1) * 3,
        source="dbeel_tpu_torch/csrc/merge_path.cu",
    )
    del key3, pre3
    merge_path_cases = _merge_path_edges(torch, np, B, rng, bit_err)
    for row in results[-3:]:
        row["edge_cases"] = merge_path_cases

    # K4 (8, 2^15, 9): full stacks with ties on all 8 compared words.
    k, p = 8, 1 << 15
    st = rng.integers(0, 2, size=(k, p, 9), dtype=np.uint64).astype(np.uint32)
    st[..., 8] = rng.permutation(k * p).reshape(k, p).astype(np.uint32)
    for r in range(k):
        st[r] = st[r][np.lexsort(st[r, :, :8].T[::-1])]
    st[1, p // 2:] = 0xFFFFFFFF  # a short run: sentinel tail
    stacks = T(st)
    record(
        "K4", "merge_runs_perm_kernel",
        "dbeel_tpu/ops/bitonic.py:104",
        lambda: B.merge_runs_perm_kernel(stacks),
        lambda: B.perm_plain(stacks),
        None,  # no single PyTorch call sorts 8 key words lexicographically
        stacks.numel() * 4 + k * p * 5,
        k * p * (k.bit_length() - 1) * 8,
    )
    # K5's schedule with P >= the tile: a staging launch, then a group
    # and a tile launch a level.
    k4 = results[-1]
    _expect_launches(k4, 1 + 2 * (k.bit_length() - 1))
    k4["passes_us"] = _pass_profile(
        torch, lambda: B.merge_runs_perm_kernel(stacks)
    )
    log(f"K4 passes (kernel, device us): {json.dumps(k4['passes_us'])}")
    # K = 1, runs below, at and above the 1024-row tile, and N = 2^20,
    # past tile^2/2, whose last level takes one launch a stride.
    k4["edge_cases"] = _schedule_edges(
        torch, np, B, np.random.default_rng(4), bit_err, "K4",
        B.merge_runs_perm_kernel, B.perm_plain,
        [(1, 8), (64, 16), (2, 1024), (4, 2048), (8, 1 << 17)],
    )
    del stacks

    # K5 (131072, 9): the flush sort's shape — one row per run (P = 1),
    # a 1000-row sentinel tail.  Then the mesh's final sort (524288, 9):
    # 4 received slots of 65568 rows (65536 flush rows and 32 sentinel
    # rows each) padded to a power of two, about half sentinel.
    def k5_bound(n):
        levels = n.bit_length() - 1
        return n * 9 * 4 * 2 + n, n // 2 * (levels * (levels + 1) // 2) * 8

    n = SHARD_CAPACITY
    stack5 = T(_k5_stack(np, rng, n, n - 1000))
    record(
        "K5", "sort_stack_kernel",
        "dbeel_tpu/ops/bitonic.py:95 (sort_stack_kernel :114)",
        lambda: B.sort_stack_kernel(stack5),
        lambda: B.merge_rows_plain(stack5[:, None]),
        None,  # no single PyTorch call sorts 8 key words lexicographically
        *k5_bound(n),
    )
    k5 = results[-1]
    n_mesh = 1 << 19
    # The shapes past the flush draw from their own generator, so that
    # the data of every later row stays as it was.
    rng5 = np.random.default_rng(5)
    slots = [_k5_stack(np, rng5, 65568, 65536) for _ in range(MESH_PARTS)]
    for slot in slots:  # each slot a sorted bucket of a sorted partition
        slot[:] = slot[np.lexsort(slot[:, :8].T[::-1])]
    pad = np.full((n_mesh - 65568 * MESH_PARTS, 9), 0xFFFFFFFF, np.uint32)
    stack_mesh = T(np.concatenate(slots + [pad]))
    if bit_err("K5", B.sort_stack_kernel(stack_mesh),
               B.merge_rows_plain(stack_mesh[:, None])):
        raise AssertionError("K5 (524288, 9): kernel disagrees with plain")
    k5["mesh_final_sort"] = dict(
        shape=[n_mesh, 9], bit_equal=True,
        **measure(lambda: B.sort_stack_kernel(stack_mesh),
                  lambda: B.merge_rows_plain(stack_mesh[:, None]),
                  *k5_bound(n_mesh)),
    )
    log(f"K5 (524288, 9): bit_equal {_timings_text(k5['mesh_final_sort'])}")
    # Each launch's device time in a call: the first launch, then a
    # group and a tile launch for each level past the tile.
    k5["passes_us"] = {
        str(x.shape[0]): _pass_profile(torch, lambda: B.sort_stack_kernel(x))
        for x in (stack5, stack_mesh)
    }
    log(f"K5 passes (kernel, device us): {json.dumps(k5['passes_us'])}")
    # N of 1, 2, 4, half a tile, a tile and two tiles; long runs; and
    # N = 2^20, past tile^2/2.
    k5["edge_cases"] = _schedule_edges(
        torch, np, B, rng5, bit_err, "K5", B.merge_runs_kernel,
        B.merge_rows_plain,
        [(n, 1) for n in (1, 2, 4, 512, 1024, 2048, 1 << 20)]
        + [(8, 1 << 14), (2, 1 << 16)],
    )
    del stack5, stack_mesh

    # K6 (8, 4, 131072, 2): the coalesced batch of the shards phase —
    # 8 jobs of 3 ragged runs plus the empty run K = 4 pads with.
    j, k, p = SHARDS, 4, SHARD_CAPACITY
    c6 = rng.integers(p // 2, p + 1, size=(j, k)).astype(np.uint32)
    c6[:, 3] = 0
    pre6 = T(_sorted_runs(np, rng, j, k, p, 2, 1 << 16, c6))
    cnt6 = T(c6)
    rows6 = int(c6.sum(axis=1).max())
    out6 = min(k * p, ((rows6 + 65535) >> 16) << 16)
    key6 = B._u64(pre6[..., 0]) << 32 | B._u64(pre6[..., 1])
    key6 = as_signed(key6).reshape(j, -1)
    record(
        "K6", "merge_runs_prefix_batch_kernel",
        "dbeel_tpu/ops/bitonic.py:284 (body _prefix_merge_body :136)",
        lambda: B.merge_runs_prefix_batch_kernel(pre6, cnt6, out6),
        lambda: B.prefix_top_batch_plain(pre6, cnt6, out6),
        lambda: torch.sort(key6, dim=1, stable=True),
        pre6.numel() * 4 + cnt6.numel() * 4 + j * out6 * 4,
        j * k * p * (k.bit_length() - 1) * 3,
        source="dbeel_tpu_torch/csrc/merge_path.cu",
    )
    # The merge path: one launch a level, the last stopping at out_rows.
    _expect_launches(results[-1], k.bit_length() - 1)
    del pre6, key6
    results[-1]["edge_cases"] = _k6_edges(
        torch, np, B, np.random.default_rng(6), bit_err
    )

    # K7 (9, 2^19): the mesh_wide merge's columns padded to a power of
    # two — random words with most first words >= 0x80000000, a block
    # of rows tied on all 8 key columns, a sentinel tail.
    from dbeel_tpu_torch.ops import merge as M
    from dbeel_tpu_torch.parallel import dist_merge as D

    n = 1 << 19
    c7 = rng.integers(0, 1 << 32, size=(9, n), dtype=np.uint64)
    c7 = c7.astype(np.uint32)
    c7[0, : n // 2] |= np.uint32(0x80000000)
    c7[:8, n // 2: n // 2 + n // 8] = rng.integers(
        0, 2, size=(8, n // 8), dtype=np.uint64
    ).astype(np.uint32)
    c7[8] = rng.permutation(n).astype(np.uint32)
    c7[:, n - 5000:] = 0xFFFFFFFF
    cols7 = T(c7)
    key7 = as_signed(B._u64(cols7[0]) << 32 | B._u64(cols7[1]))
    levels7 = n.bit_length() - 1
    record(
        "K7", "sort_dedup_kernel",
        "dbeel_tpu/ops/merge.py:35 (_sort_kernel; _same_key_mask :42)",
        lambda: M.sort_dedup_kernel(cols7),
        lambda: M.sort_dedup_plain(cols7),
        lambda: torch.sort(key7, stable=True),
        cols7.numel() * 4 * 2 + n,
        n // 2 * (levels7 * (levels7 + 1) // 2) * 8,
        module="merge", source="dbeel_tpu_torch/csrc/bitonic.cu",
    )
    # K5's schedule with P = 1: a first tile launch that reads the
    # columns, then a group and a tile launch a level past the tile.
    k7 = results[-1]
    _expect_launches(k7, 1 + 2 * (levels7 - 10))
    k7["passes_us"] = _pass_profile(torch, lambda: M.sort_dedup_kernel(cols7))
    log(f"K7 passes (kernel, device us): {json.dumps(k7['passes_us'])}")
    del cols7, key7
    k7["edge_cases"] = _k7_edges(torch, np, B, M, bit_err)

    # K9b (131072, 9) → (4, 65568, 9) from the gathered samples of 4
    # partitions: the wide cell's local stack, sorted, first words from
    # a few values (ties across splitters, >= 0x80000000, 0xFFFFFFFF)
    # and a sentinel tail; held at the wide capacity and at one small
    # enough to overflow.  First the splitter pick folded into its
    # launch (K9a's former row): 8 trials of gathered samples — first
    # words >= 0x80000000 and runs of equal samples across the splitter
    # positions — each call's splitters bit-equal to the plain pick.
    n_dev = MESH_PARTS
    words9 = np.array([0, 5, 0x7FFFFFFF, 0x80000000, 0x80000001,
                       0xC0000000, 0xFFFFFFFE, 0xFFFFFFFF], dtype=np.uint64)
    smp = T(rng.choice(words9, size=n_dev * 32).astype(np.uint32))
    trials = [T(rng.choice(words9[trial % 4:], size=n_dev * 32)
                .astype(np.uint32)) for trial in range(8)]
    m9 = 131072
    cap9 = int(m9 * 2.0 / n_dev) + 32
    loc = rng.integers(0, 1 << 32, size=(m9, 9), dtype=np.uint64)
    loc = loc.astype(np.uint32)
    loc[:, 0] = rng.choice(words9, size=m9, p=[.05, .05, .2, .2, .2, .2,
                                                 .05, .05])
    loc[:, 4] = rng.integers(1, 64, size=m9).astype(np.uint32)
    loc[m9 - 3000:] = 0xFFFFFFFF
    loc[: m9 - 3000] = loc[: m9 - 3000][np.lexsort(loc[: m9 - 3000, :8].T[::-1])]
    local9 = T(loc)
    for trial, s_t in enumerate(trials):
        got = D.bucket_scatter_kernel(local9, s_t, cap9, n_dev)[2]
        if bit_err("K9a", got, D.splitters_plain(s_t, n_dev)):
            raise AssertionError(f"K9a trial {trial}: splitters differ")
    pos9 = torch.arange(n_dev * 32, device=dev) * m9 // (n_dev * 32)
    smp9 = local9[pos9, 0].contiguous()
    for cap in (cap9, 20000):
        if bit_err("K9b", D.bucket_scatter_kernel(local9, smp9, cap, n_dev),
                   D.pick_scatter_plain(local9, smp9, cap, n_dev)):
            raise AssertionError(f"K9b capacity {cap}: outputs differ")
    over9 = int(D.bucket_scatter_kernel(local9, smp9, 20000, n_dev)[1].item())
    if over9 <= 0:
        raise AssertionError("K9b: the small capacity did not overflow")
    k0_9 = B._u64(local9[:, 0])
    spl64 = B._u64(D.splitters_plain(smp9, n_dev))
    record(
        "K9b", "bucket_scatter_kernel",
        "dbeel_tpu/parallel/dist_merge.py:117 (_dist_kernel; body "
        "_per_device :67, splitters :76-86 and bucket + scatter :88-102)",
        lambda: D.bucket_scatter_kernel(local9, smp9, cap9, n_dev),
        lambda: D.pick_scatter_plain(local9, smp9, cap9, n_dev),
        lambda: torch.bucketize(k0_9, spl64),
        local9.numel() * 4 + n_dev * cap9 * 9 * 4 + smp9.numel() * 4
        + (n_dev - 1) * 4 + 4,
        m9 * (n_dev - 1),
        module="dist", wrapper="parallel/dist_merge.py",
    )
    log(f"K9b: the overflow check dropped {over9} rows at capacity 20000")
    k9b = results[-1]
    k9b["host_parts_us"] = _k9b_host_parts(torch, D, local9, smp9, cap9,
                                           n_dev)
    k9b["edge_cases"] = _k9b_edges(torch, np, B, D,
                                   np.random.default_rng(9), bit_err)
    del local9, k0_9
    # K9a's row: the pick runs inside K9b's launch and has no launch,
    # counter or call of its own, so its times are the fused call's.
    smp64 = B._u64(smp)
    bound9a = (smp.numel() * 4 + (n_dev - 1) * 4) / PEAK_BYTES_PER_S * 1e3
    k9a = {
        "name": "K9a",
        "route": "cuda",
        "source": "dbeel_tpu_torch/csrc/dist.cu",
        "wrapper": "dbeel_tpu_torch/parallel/dist_merge.py:"
                   "bucket_scatter_kernel",
        "replaces": "dbeel_tpu/parallel/dist_merge.py:117 (_dist_kernel; "
                    "body _per_device :67, splitters :76-86)",
        "folded_into": "K9b",
        "launches": 0,
        "bit_equal": True,
        "max_abs_err": 0,
        "trials": len(trials),
        **{k: k9b[k] for k in ("ms", "device_ms", "host_us",
                               "device_kernels", "device_launches_per_call")},
        "plain_ms": _time_cuda(torch, lambda: D.splitters_plain(smp, n_dev), 3),
        "bound_ms": bound9a,
        "bound_by": "bytes",
        "library_ms": _time_cuda(torch, lambda: torch.sort(smp64), 20),
    }
    log(f"K9a: folded into K9b, {len(trials)} trials and K9b's edges "
        f"bit_equal; {_timings_text(k9a)} library_ms={k9a['library_ms']}")
    results.insert(len(results) - 1, k9a)

    # K8a-K8d at the scan phase's shape: one staged float64 column of
    # SCAN_DOCS rows, 20% invalid, salted with NaN, +-inf, +-0.0,
    # subnormals and exact ties to the operands.
    from dbeel_tpu_torch.ops import query_kernels as Q

    n = SCAN_DOCS
    inf, nan = float("inf"), float("nan")
    odd = [0.0, -0.0, 0.25, -0.25, inf, -inf, nan, 5e-324, -5e-324,
           2.2250738585072014e-308]
    vals_np = rng.normal(size=n) * rng.choice([1e-3, 1.0, 1e6], size=n)
    pick = rng.random(n) < 0.3
    vals_np[pick] = rng.choice(odd, size=int(pick.sum()))
    valid_np = rng.random(n) >= 0.2
    vals = torch.from_numpy(vals_np).to(dev)
    valid = torch.from_numpy(valid_np).to(dev)
    for op in Q.OPS:
        for x in (0.25, -0.0, nan, inf, 5e-324, float(vals_np[7])):
            err = bit_err("K8a", Q.cmp_f64(vals, valid, x, op),
                          Q.cmp_f64_plain(vals, valid, x, op))
            if err:
                raise AssertionError(f"K8a {op} {x}: masks differ")
    for lo, hi, use_lo, use_hi in ((-0.25, 0.0, True, False),
                                   (0.0, 0.25, False, True),
                                   (-0.0, 0.25, True, True),
                                   (-inf, 5e-324, True, True)):
        err = bit_err("K8b", Q.range_f64(vals, valid, lo, hi, use_lo, use_hi),
                      Q.range_f64_plain(vals, valid, lo, hi, use_lo, use_hi))
        if err:
            raise AssertionError(f"K8b {lo} {hi} {use_lo} {use_hi}: differ")
    finite = valid & torch.isfinite(vals)
    zero = vals == 0
    masks = {
        "valid": valid, "finite": finite, "empty": torch.zeros_like(valid),
        "zeros": zero, "neg_zeros": zero & torch.signbit(vals),
        "pos_zeros": zero & ~torch.signbit(vals),
    }
    for name, m in masks.items():
        if bit_err("K8d", Q.min_max_f64(vals, m), Q.min_max_f64_plain(vals, m)):
            raise AssertionError(f"K8d {name}: min/max differ")
    if not math.isnan(Q.sum_f64(vals, valid).item()):
        raise AssertionError("K8c: a masked-in NaN did not propagate")
    host_parts = _k8_edges(torch, np, Q, rng, odd, bit_err)
    # Library yardsticks: one PyTorch call on an operand prepared
    # outside the timed call (invalid rows as NaN for the comparison,
    # zero-filled rows for the sum, the selected rows for aminmax).
    vals_nan = torch.where(valid, vals, nan)
    vals_zero = torch.where(finite, vals, 0.0)
    vals_sel = vals[finite]
    sel = vals_np[finite.cpu().numpy()]
    exact_sum = math.fsum(sel.tolist())
    sum_bound = n * 2.0**-52 * float(np.abs(sel).sum())

    def sum_check(got, _want):
        err = abs(got.item() - exact_sum)
        if not err <= sum_bound:
            raise AssertionError(f"K8c: |sum - fsum| {err} > {sum_bound}")
        return err

    record(
        "K8a", "cmp_f64",
        "dbeel_tpu/ops/query_kernels.py:154 (wrapper eval_cmp_f64 :197)",
        lambda: Q.cmp_f64(vals, valid, 0.25, "<"),
        lambda: Q.cmp_f64_plain(vals, valid, 0.25, "<"),
        lambda: torch.lt(vals_nan, 0.25),
        n * 10, n * 2, module="query_kernels",
    )
    results[-1]["host_parts_us"] = host_parts
    record(
        "K8b", "range_f64",
        "dbeel_tpu/ops/query_kernels.py:170 (wrapper eval_range_f64 :219)",
        lambda: Q.range_f64(vals, valid, -0.25, 0.25, True, True),
        lambda: Q.range_f64_plain(vals, valid, -0.25, 0.25, True, True),
        None,  # no single PyTorch call tests a two-sided range
        n * 10, n * 3, module="query_kernels",
    )
    record(
        "K8c", "sum_f64", "dbeel_tpu/ops/query_kernels.py:179",
        lambda: Q.sum_f64(vals, finite),
        lambda: Q.sum_f64_plain(vals, finite),
        lambda: torch.sum(vals_zero),
        n * 9, n, module="query_kernels", check=sum_check,
    )
    record(
        "K8d", "min_max_f64", "dbeel_tpu/ops/query_kernels.py:183",
        lambda: Q.min_max_f64(vals, valid),
        lambda: Q.min_max_f64_plain(vals, valid),
        lambda: torch.aminmax(vals_sel),
        n * 9, n * 2, module="query_kernels",
    )
    return results


# ----------------------------------------------------------------------
# Phase 3: compaction at bench scale
# ----------------------------------------------------------------------


def _write_table(dir_path, index, blob, offsets, key_size, full_size):
    """One SSTable triplet through the port's writers: data and index
    via PageMirroringWriter (page CRCs), then the .sums sidecar."""
    import numpy as np
    from dbeel_tpu_torch.storage import checksums
    from dbeel_tpu_torch.storage.entry import (
        DATA_FILE_EXT, INDEX_FILE_EXT, file_name,
    )
    from dbeel_tpu_torch.storage.file_io import PageMirroringWriter

    idx = np.zeros(offsets.size, dtype=np.dtype(
        [("offset", "<u8"), ("key_size", "<u4"), ("full_size", "<u4")]
    ))
    idx["offset"], idx["key_size"], idx["full_size"] = (
        offsets, key_size, full_size
    )
    data_w = PageMirroringWriter(
        f"{dir_path}/{file_name(index, DATA_FILE_EXT)}",
        (DATA_FILE_EXT, index), None,
    )
    view = memoryview(blob)
    for off in range(0, len(view), 32 << 20):
        data_w.write(view[off: off + (32 << 20)])
    size = data_w.close()
    index_w = PageMirroringWriter(
        f"{dir_path}/{file_name(index, INDEX_FILE_EXT)}",
        (INDEX_FILE_EXT, index), None,
    )
    index_w.write(idx.tobytes())
    index_w.close()
    checksums.write(dir_path, index, data_w.page_crcs, index_w.page_crcs,
                    size, None)


def build_bench_runs(np, dir_path, total_keys, n_runs, seed=7):
    """bench.py's fixed-size generator (16 B keys, 64 B values, ts by
    run and position), written with the port's writers."""
    key_bytes, value_bytes = 16, 64
    record = 16 + key_bytes + value_bytes
    rng = np.random.default_rng(seed)
    per_run = total_keys // n_runs
    for r in range(n_runs):
        keys = rng.integers(0, 256, size=(per_run, key_bytes), dtype=np.uint8)
        kv = np.ascontiguousarray(keys).view(">u8").reshape(per_run, 2)
        # bench.py's argsort(order=("a", "b")): the same order, by lexsort.
        keys = keys[np.lexsort((kv[:, 1], kv[:, 0]))]
        ts = (np.int64(r) * total_keys + np.arange(per_run)).astype("<i8")
        arr = np.zeros((per_run, record), dtype=np.uint8)
        hdr = arr[:, :16].view("<u4")
        hdr[:, 0] = key_bytes
        hdr[:, 1] = value_bytes
        arr[:, 8:16] = ts.view(np.uint8).reshape(per_run, 8)
        arr[:, 16:32] = keys
        arr[:, 32:] = (
            keys[:, :8].astype(np.uint16).sum(axis=1) % 251
        ).astype(np.uint8)[:, None]
        _write_table(
            dir_path, r * 2, arr.reshape(-1),
            np.arange(per_run, dtype=np.uint64) * record,
            key_bytes, record,
        )
    return [r * 2 for r in range(n_runs)]


def build_dense_runs(np, dir_path, per_run, n_runs):
    """Sequential 8-byte ids interleaved across runs plus one far
    outlier: the partition holding the outlier spans > 2^32, and the
    shifted 1-word operand would collapse its dense cluster, so the
    pipeline keeps the exact 2-word operand there (K2)."""
    key_bytes, value_bytes = 16, 64
    record = 16 + key_bytes + value_bytes
    for r in range(n_runs):
        ids = np.arange(r, per_run * n_runs, n_runs, dtype=np.uint64)
        if r == 0:
            ids[-1] = np.uint64(1) << np.uint64(62)
        keys = np.zeros((per_run, key_bytes), dtype=np.uint8)
        keys[:, :8] = ids.astype(">u8").view(np.uint8).reshape(per_run, 8)
        keys[:, 8:] = 7
        arr = np.zeros((per_run, record), dtype=np.uint8)
        hdr = arr[:, :16].view("<u4")
        hdr[:, 0] = key_bytes
        hdr[:, 1] = value_bytes
        arr[:, 8:16] = (
            np.full(per_run, 1000 + r, "<i8").view(np.uint8).reshape(-1, 8)
        )
        arr[:, 16:32] = keys
        arr[:, 32:] = r + 1
        _write_table(
            dir_path, r * 2, arr.reshape(-1),
            np.arange(per_run, dtype=np.uint64) * record,
            key_bytes, record,
        )
    return [r * 2 for r in range(n_runs)]


def _merge_only(strategy, dir_path, indices, out_index):
    """One strategy.merge of the tables ``indices``: (entries out,
    entries in, seconds)."""
    from dbeel_tpu_torch.storage.sstable import SSTable

    sources = [SSTable(dir_path, i, None) for i in indices]
    t0 = time.perf_counter()
    result = strategy.merge(sources, dir_path, out_index, None, False, 1)
    elapsed = time.perf_counter() - t0
    total_in = sum(s.entry_count for s in sources)
    for s in sources:
        s.close()
    return result.entry_count, total_in, elapsed


def _output_digest(dir_path, out_index):
    """SHA-256 of a merge's output files, which it then removes."""
    from dbeel_tpu_torch.storage.entry import file_name

    digest = hashlib.sha256()
    for ext in ("compact_data", "compact_index", "compact_bloom",
                "compact_sums"):
        p = f"{dir_path}/{file_name(out_index, ext)}"
        with open(p, "rb") as f:
            digest.update(f.read())
        os.unlink(p)
    return digest.hexdigest()


def _merge(strategy, dir_path, indices, out_index):
    n_out, total_in, elapsed = _merge_only(
        strategy, dir_path, indices, out_index
    )
    digest = _output_digest(dir_path, out_index)
    return total_in / elapsed, n_out, digest, elapsed


def _main_path_run(fn):
    """Drive one run of the main path with every launch counter zeroed
    just before it; returns fn's result and the counts read just after."""
    from dbeel_tpu_torch.ops import bitonic as B

    B.reset_launches()
    out = fn()
    return out, dict(B.launches)


@contextlib.contextmanager
def _device_trace(torch, device):
    """torch.profiler over the block on a card (yields the profiler);
    nothing to trace on the CPU (yields None)."""
    if torch.device(device).type != "cuda":
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
    ) as prof:
        yield prof


def _device_busy(prof):
    """The card's busy ms (kernels + copies) in a trace, and its top
    device activities."""
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us, ev.key, ev.count))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    top = "; ".join(f"{k[:48]} x{c} {us / 1e3:.2f}ms" for us, k, c in rows[:5])
    return busy_ms, top


def _profile_merge(torch, strategy, dir_path, indices):
    """One more merge of the bench cell under torch.profiler: the card's
    busy time (kernels + copies) against the merge's wall time, and the
    top device activities.  Runs after the main path's counts are read."""
    with _device_trace(torch, "cuda") as prof:
        _, _, _, wall_s = _merge(strategy, dir_path, indices, 105)
    busy_ms, top = _device_busy(prof)
    log(f"profile: merge wall {wall_s * 1e3:.1f}ms (traced), device busy "
        f"{busy_ms:.2f}ms = {busy_ms / (wall_s * 1e3):.4f} of wall; top: {top}")


def phase_compaction(torch, np, card, total_keys, strategy):
    """``strategy`` is the one-card strategy under test
    (get_strategy("device")).  Returns the launch counts of the bench
    and dense runs, and the bench runs (kept on disk for the mesh
    phase) with the host merge's digest and the card's rate."""
    from dbeel_tpu_torch.ops import pipeline
    from dbeel_tpu_torch.storage.compaction import get_strategy

    d = os.path.join(WORK, "bench")
    os.makedirs(d)
    t0 = time.perf_counter()
    idx = build_bench_runs(np, d, total_keys, 8)
    log(f"compaction: built 8 runs of {total_keys // 8} docs in "
        f"{time.perf_counter() - t0:.1f}s")
    runs_before = pipeline.pipeline_stats["runs"]
    (dev_rate, dev_n, dev_sha, dev_s), bench = _main_path_run(
        lambda: _merge(strategy, d, idx, 101)
    )
    log(f"launches bench: {bench}")
    if pipeline.pipeline_stats["runs"] == runs_before or bench["K1"] == 0:
        raise AssertionError("the bench merge did not run the pipeline/K1")
    cpu_rate, cpu_n, cpu_sha, cpu_s = _merge(get_strategy("cpu"), d, idx, 103)
    # The C++ k-way merge: bench.py's default baseline, on the host.
    nat_rate, nat_n, nat_sha, nat_s = _merge(
        get_strategy("native"), d, idx, 107
    )
    log(f"compaction {total_keys} docs on {card}: device (card pipeline) "
        f"{dev_rate:.0f} keys/s ({dev_s:.2f}s), cpu {cpu_rate:.0f} keys/s "
        f"({cpu_s:.2f}s), native {nat_rate:.0f} keys/s ({nat_s:.2f}s), "
        f"entries {dev_n}, sha256 equal: "
        f"{dev_sha == cpu_sha == nat_sha}")
    if (dev_n, dev_sha) != (cpu_n, cpu_sha):
        raise AssertionError("card merge output differs from the cpu merge")
    if (nat_n, nat_sha) != (cpu_n, cpu_sha):
        raise AssertionError("native merge output differs from the cpu merge")
    _profile_merge(torch, strategy, d, idx)
    runs_kept = dict(dir=d, idx=idx, sha=cpu_sha, n=cpu_n, rate=dev_rate)

    d = os.path.join(WORK, "dense")
    os.makedirs(d)
    idx = build_dense_runs(np, d, 1 << 18, 4)
    (_, n_a, sha_a, dense_s), dense = _main_path_run(
        lambda: _merge(strategy, d, idx, 101)
    )
    log(f"launches dense: {dense}")
    _, n_b, sha_b, _ = _merge(get_strategy("cpu"), d, idx, 103)
    log(f"compaction dense-cluster keyspace: {dense_s:.2f}s, "
        f"sha256 equal: {sha_a == sha_b}")
    if (n_a, sha_a) != (n_b, sha_b):
        raise AssertionError("dense-cluster merge differs from the cpu merge")
    if dense["K2"] == 0:
        raise AssertionError(f"dense merge did not launch K2: {dense}")
    shutil.rmtree(d)
    runs_kept["dense"] = dict(n=n_a, sha=sha_a, launches=dense)
    return {"bench": bench, "dense": dense}, runs_kept


# ----------------------------------------------------------------------
# Phase 4: LSMTree write → flush → compact → get
# ----------------------------------------------------------------------


async def _drive_tree(d, ops, probe_keys, strategy):
    """``ops`` — (key, value or None for a delete) — applied with
    deterministic timestamps, flushes at capacity, one final flush;
    returns the oracle's mismatches over ``probe_keys`` after a major
    compaction, which runs with the launch counters zeroed just before
    it and read just after (returned too)."""
    from dbeel_tpu_torch.ops import bitonic as B
    from dbeel_tpu_torch.storage import LSMTree
    from dbeel_tpu_torch.storage.page_cache import PageCache, PartitionPageCache

    # A page cache as a serving shard has (64 MiB): gets after the
    # first touch of a page resolve without an executor hop.
    cache = PartitionPageCache(os.path.basename(d), PageCache(16384))
    tree = LSMTree.open_or_create(
        d, cache=cache, strategy=strategy, bloom_min_size=1 << 16
    )
    oracle = {}
    t0 = time.perf_counter()
    for i, (key, value) in enumerate(ops):
        if value is None:
            await tree.delete_with_timestamp(key, 1_000 + i)
        else:
            await tree.set_with_timestamp(key, value, 1_000 + i)
        oracle[key] = value
    t_write = time.perf_counter() - t0
    await tree.flush()
    tables = [i for i, _ in tree.sstable_indices_and_sizes()]
    t0 = time.perf_counter()
    B.reset_launches()
    await tree.compact(tables, max(tables) + 1, keep_tombstones=False)
    counts = dict(B.launches)
    t_compact = time.perf_counter() - t0
    t0 = time.perf_counter()
    bad = 0
    for key in probe_keys:
        if await tree.get(key) != oracle.get(key):
            bad += 1
    log(f"lsm {os.path.basename(d)}: {len(ops)} writes {t_write:.1f}s, "
        f"compact of {len(tables)} tables {t_compact:.2f}s, "
        f"{len(probe_keys)} gets {time.perf_counter() - t0:.1f}s, "
        f"oracle mismatches {bad}, launches {counts}")
    tree.close()
    return bad, counts


def phase_lsm(np, n_ops, strategy):
    """Two trees; returns the launch counts of each one's compaction."""
    rng = np.random.default_rng(3)
    # Tree a: 16-hex-digit keys (diverse leading 8 bytes), mostly fresh
    # inserts with 0.5% overwrites and 0.5% deletes of written keys, so
    # the merge's prefix ties stay under the tie-fallback threshold and
    # K3's order goes straight to the host tie fixup.
    n_a = n_ops * 3 // 5
    fresh = iter(b"%016x" % int(x) for x in
                 rng.integers(0, 1 << 64, size=n_a, dtype=np.uint64))
    written, ops_a = [], []
    for i, u in enumerate(rng.random(n_a)):
        if u < 0.01 and written:
            key = written[int(rng.integers(0, len(written)))]
            ops_a.append((key, None if u < 0.005 else b"v%d-" % i + key))
        else:
            written.append(next(fresh))
            ops_a.append((written[-1], b"v%d-" % i + written[-1]))
    probe_a = written + [b"%016x-absent" % i for i in range(2000)]
    # Tree b: keys sharing their first 8 bytes, random overwrites and 8%
    # deletes — nearly every merge row ties on its prefix, so the
    # strategy re-sorts on the full stack (K4).
    shared = [b"user:000" + b"%08d" % i for i in range(n_ops // 4)]
    n_b = n_ops * 2 // 5
    picks = rng.integers(0, len(shared), size=n_b)
    deletes = rng.random(n_b) < 0.08
    ops_b = [
        (shared[p], None if deletes[i] else b"v%d-" % i + shared[p])
        for i, p in enumerate(picks)
    ]
    t0 = time.perf_counter()
    bad_a, lsm_a = asyncio.run(
        _drive_tree(os.path.join(WORK, "lsm_a"), ops_a, probe_a, strategy)
    )
    bad_b, lsm_b = asyncio.run(
        _drive_tree(os.path.join(WORK, "lsm_b"), ops_b, shared, strategy)
    )
    log(f"lsm: {n_ops} ops over two trees, oracle mismatches "
        f"{bad_a + bad_b}, {time.perf_counter() - t0:.1f}s")
    if bad_a or bad_b:
        raise AssertionError(f"{bad_a + bad_b} gets disagree with the oracle")
    if lsm_a["K3"] == 0 or lsm_a["K4"] != 0:
        raise AssertionError(f"tree a did not take the K3-only route: {lsm_a}")
    if lsm_b["K3"] == 0 or lsm_b["K4"] == 0:
        raise AssertionError(f"tree b did not take K3 then K4: {lsm_b}")
    return {"lsm_a": lsm_a, "lsm_b": lsm_b}


# ----------------------------------------------------------------------
# Phase 5: one node's shards on one card
# ----------------------------------------------------------------------


def shard_ops(np, shard, n_ops, seed=7, overwrites=0.005, deletes=0.005):
    """One shard's ops: bench.py's widths (16 B random keys, 64 B
    values), the given shares of overwrites and deletes of keys written
    earlier; (key, value or None for a delete), timestamps 1000 +
    position."""
    rng = np.random.default_rng([seed, shard])
    key_blob = rng.integers(0, 256, size=n_ops * 16, dtype=np.uint8).tobytes()
    val_blob = rng.integers(0, 256, size=n_ops * 64, dtype=np.uint8).tobytes()
    u = rng.random(n_ops)
    earlier = rng.random(n_ops)
    ops = []
    for i in range(n_ops):
        if u[i] < deletes + overwrites and i:
            key = ops[int(earlier[i] * i)][0]
        else:
            key = key_blob[i * 16: i * 16 + 16]
        value = None if u[i] < deletes and i else val_blob[i * 64: i * 64 + 64]
        ops.append((key, value))
    return ops


async def _write_tree(tree, ops):
    """Apply ``ops``; a full memtable flushes on the way (a writer runs
    without yielding until it waits for that flush to start)."""
    for i, (key, value) in enumerate(ops):
        if value is None:
            await tree.delete_with_timestamp(key, 1_000 + i)
        else:
            await tree.set_with_timestamp(key, value, 1_000 + i)


async def _settle(skip=()):
    """Await every task the trees spawned (capacity-triggered flushes),
    all but those in ``skip`` (a shard's own, which run until it
    closes)."""
    others = [t for t in asyncio.all_tasks()
              if t is not asyncio.current_task() and t not in skip]
    await asyncio.gather(*others)


def _table_digests(d):
    """SHA-256 of every file of a tree's directory but its WALs."""
    out = {}
    for f in sorted(os.listdir(d)):
        if not f.endswith(".memtable"):
            with open(os.path.join(d, f), "rb") as fh:
                out[f] = hashlib.sha256(fh.read()).hexdigest()
    return out


async def _drive_shards(torch, np, n_shards, n_ops, capacity, device):
    from dbeel_tpu_torch.ops import bitonic as B
    from dbeel_tpu_torch.ops import sort
    from dbeel_tpu_torch.server.coalescer import (
        CoalescedDeviceMergeStrategy,
        CompactionCoalescer,
    )
    from dbeel_tpu_torch.server.tasks import compact_tree
    from dbeel_tpu_torch.storage import LSMTree
    from dbeel_tpu_torch.storage.compaction import get_strategy
    from dbeel_tpu_torch.storage.entry import (
        COMPACT_BLOOM_FILE_EXT, COMPACT_DATA_FILE_EXT, COMPACT_INDEX_FILE_EXT,
        file_name,
    )
    from dbeel_tpu_torch.storage.page_cache import (
        PageCache, PartitionPageCache,
    )
    from dbeel_tpu_torch.storage.sstable import SSTable

    t0 = time.perf_counter()
    ops = [shard_ops(np, s, n_ops) for s in range(n_shards)]
    log(f"shards: {n_shards} x {n_ops} ops generated in "
        f"{time.perf_counter() - t0:.1f}s")
    # The window is long and max_batch is the shard count, so all the
    # shards' compactions meet in one launch however long each takes to
    # load its columns.
    coalescer = CompactionCoalescer(
        window_s=120.0, max_batch=n_shards, device=device
    )
    cache = PageCache(16384 * n_shards)
    dirs = [os.path.join(WORK, "shards", f"shard{s}") for s in range(n_shards)]
    trees = [
        LSMTree.open_or_create(
            d, cache=PartitionPageCache(os.path.basename(d), cache),
            capacity=capacity, memtable_kind="hash", device=device,
            strategy=CoalescedDeviceMergeStrategy(coalescer),
        )
        for d in dirs
    ]

    # Run shards_flush: every shard's writes, with its flushes.
    B.reset_launches()
    t0 = time.perf_counter()
    await asyncio.gather(*(_write_tree(t, o) for t, o in zip(trees, ops)))
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    await asyncio.gather(*(t.flush() for t in trees))
    await _settle()
    t_flush = time.perf_counter() - t0
    flush_counts = dict(B.launches)
    entries = []
    for d, tree in zip(dirs, trees):
        entries.append([])
        for i, _ in tree.sstable_indices_and_sizes():
            table = SSTable(d, i, None)
            entries[-1].append(table.entry_count)
            table.close()
    log(f"shards write: {n_shards * n_ops} ops over {n_shards} shards in "
        f"{t_write:.1f}s (2 capacity-triggered flushes per shard "
        f"overlapped), then the last memtables of all shards flushed "
        f"together in {t_flush:.2f}s; entries per flushed table "
        f"{entries}; launches {flush_counts}")
    for e in entries:
        if len(e) != 3 or min(e) < sort.DEVICE_THRESHOLD:
            raise AssertionError(
                f"want 3 flushes of >= {sort.DEVICE_THRESHOLD} items per "
                f"shard, got {entries}"
            )

    # A copy of each shard's flushed tables for the cpu merge and the
    # sorted-memtable twin.
    refs = [os.path.join(WORK, "shards_ref", f"shard{s}")
            for s in range(n_shards)]
    for d, r in zip(dirs, refs):
        shutil.copytree(d, r, ignore=shutil.ignore_patterns("*.memtable"))

    # Run shards_compact: the size-tiered decision per shard, all
    # shards at once, as each shard's compaction loop would ask.
    B.reset_launches()
    t0 = time.perf_counter()
    with _device_trace(torch, device) as prof:
        await asyncio.gather(
            *(compact_tree(t, COMPACTION_FACTOR) for t in trees)
        )
    t_compact = time.perf_counter() - t0
    compact_counts = dict(B.launches)
    if prof is not None:
        busy_ms, top = _device_busy(prof)
        log(f"profile: shards compaction wall {t_compact * 1e3:.1f}ms "
            f"(traced), device busy {busy_ms:.2f}ms = "
            f"{busy_ms / (t_compact * 1e3):.4f} of wall; top: {top}")
    stats = coalescer.stats()
    log(f"shards compact: {t_compact:.2f}s; coalesced batch J="
        f"{stats['last_batch_jobs']} K={stats['last_batch_k']} "
        f"P={stats['last_batch_p']} pad_frac={stats['last_pad_frac']}; "
        f"coalescer {stats}; launches {compact_counts}")
    if (stats["launches"], stats["jobs_coalesced"]) != (1, n_shards):
        raise AssertionError(f"want one launch of {n_shards} jobs: {stats}")
    after = [[i for i, _ in t.sstable_indices_and_sizes()] for t in trees]
    if any(a != [1] for a in after):
        raise AssertionError(f"compaction left tables {after}")

    # Each shard's output against the cpu strategy's merge of its copy.
    t0 = time.perf_counter()
    cpu = get_strategy("cpu")
    for s, (d, r) in enumerate(zip(dirs, refs)):
        srcs = [SSTable(r, i, None) for i in (0, 2, 4)]
        cpu.merge(srcs, r, 1, None, False, trees[s].bloom_min_size)
        for t in srcs:
            t.close()
        got, want = _table_digests(d), _table_digests(r)
        for ext, cext in (("data", COMPACT_DATA_FILE_EXT),
                          ("index", COMPACT_INDEX_FILE_EXT),
                          ("bloom", COMPACT_BLOOM_FILE_EXT)):
            if got.get(file_name(1, ext)) != want.get(file_name(1, cext)):
                raise AssertionError(
                    f"shard {s}: {ext} differs from the cpu merge"
                )
    log(f"shards: every compacted .data/.index/.bloom SHA-256-equal to the "
        f"cpu merge ({time.perf_counter() - t0:.1f}s)")

    # Seeded oracle gets: every deleted and overwritten key, a sample of
    # the rest, and absent keys.
    t0 = time.perf_counter()
    rng = np.random.default_rng(7)
    bad = n_gets = 0
    for tree, shard_o in zip(trees, ops):
        oracle, counts = {}, {}
        for key, value in shard_o:
            oracle[key] = value
            counts[key] = counts.get(key, 0) + 1
        probe = [k for k, v in oracle.items() if v is None or counts[k] > 1]
        keys = list(oracle)
        probe += [keys[int(i)] for i in
                  rng.integers(0, len(keys), size=min(16384, len(keys)))]
        probe += [b"absent-%09d" % i for i in range(1024)]
        for key in probe:
            if await tree.get(key) != oracle.get(key):
                bad += 1
        n_gets += len(probe)
    t_get = time.perf_counter() - t0
    log(f"shards gets: {n_gets} oracle gets in {t_get:.1f}s, "
        f"mismatches {bad}")
    for tree in trees:
        tree.close()
    if bad:
        raise AssertionError(f"{bad} shard gets disagree with the oracle")

    # One flush sort alone, end to end (key staging, K5, the copy back
    # and the host gather), on shard 0's last memtable of items; after
    # the counted runs.
    last = {}
    for i, (key, value) in enumerate(ops[0][-capacity:]):
        last[key] = (b"" if value is None else value, i)
    items = list(last.items())
    t0 = time.perf_counter()
    ordered = sort.sort_items(items, device)
    t_sort = time.perf_counter() - t0
    if ordered != sorted(items, key=lambda kv: kv[0]):
        raise AssertionError("the flush sort disagrees with sorted()")
    log(f"shards flush sort: {len(items)} items in {t_sort:.3f}s end to "
        f"end, alone")

    # The sorted-memtable twin of shard 0: the same ops flush to the
    # same tables.
    t0 = time.perf_counter()
    twin_dir = os.path.join(WORK, "shards", "twin")
    twin = LSMTree.open_or_create(
        twin_dir, capacity=capacity, memtable_kind="sorted",
        strategy=get_strategy("cpu"),
    )
    await _write_tree(twin, ops[0])
    await twin.flush()
    await _settle()
    twin.close()
    twin_digest = _table_digests(twin_dir)
    flushed = {f: h for f, h in _table_digests(refs[0]).items()
               if not f.startswith(file_name(1, ""))}
    log(f"shards twin: sorted-memtable shard 0 rewritten in "
        f"{time.perf_counter() - t0:.1f}s, flushed tables SHA-256-equal: "
        f"{twin_digest == flushed}")
    if twin_digest != flushed:
        raise AssertionError("hash and sorted memtables flushed differently")
    return {"shards_flush": flush_counts, "shards_compact": compact_counts}


def phase_shards(torch, np, n_shards=SHARDS, n_ops=SHARD_OPS,
                 capacity=SHARD_CAPACITY, device="cuda"):
    """Returns the launch counts of the flush and compaction runs."""
    t0 = time.perf_counter()
    runs = asyncio.run(
        _drive_shards(torch, np, n_shards, n_ops, capacity, device)
    )
    shutil.rmtree(os.path.join(WORK, "shards"))
    shutil.rmtree(os.path.join(WORK, "shards_ref"))
    log(f"shards: {time.perf_counter() - t0:.1f}s")
    return runs


def check_shard_launches(runs, n_shards=SHARDS):
    """Three K5 flushes per shard and nothing else; one K6 launch for
    the compaction and nothing else."""
    flush, compact = runs["shards_flush"], runs["shards_compact"]
    want_flush = {name: 0 for name in flush}
    want_flush["K5"] = 3 * n_shards
    want_compact = {name: 0 for name in compact}
    want_compact["K6"] = 1
    if flush != want_flush or compact != want_compact:
        raise AssertionError(
            f"shards launches: flush {flush} (want {want_flush}), "
            f"compact {compact} (want {want_compact})"
        )


# ----------------------------------------------------------------------
# Phase 6: one shard's collection, filtered
# ----------------------------------------------------------------------


def scan_docs(np, n, seed=7):
    """blackbox_bench.py --scan-filter's collection (keys
    msgpack("key-%08d"), documents {"v": j, "blob": "x" * 100}, loaded
    in key order), then 1% of the keys overwritten with a new v below n
    and another 0.5% deleted, interleaved (seeded).  Returns (loads,
    updates) as (key, value or None for a delete, ts, v)."""
    from dbeel_tpu_torch.utils import msgpack_codec as codec

    blob = "x" * 100
    loads = [
        (codec.packb("key-%08d" % j), codec.packb({"v": j, "blob": blob}),
         1_000 + j, j)
        for j in range(n)
    ]
    rng = np.random.default_rng(seed)
    n_over, n_del = n // 100, n // 200
    picks = rng.permutation(n)[: n_over + n_del].tolist()
    new_v = rng.integers(0, n, size=n_over).tolist() + [None] * n_del
    updates = []
    for i, u in enumerate(rng.permutation(n_over + n_del).tolist()):
        key, v = loads[picks[u]][0], new_v[u]
        value = None if v is None else codec.packb({"v": v, "blob": blob})
        updates.append((key, value, 1_000 + n + i, v))
    return loads, updates


async def _scan_pass(tree, where, agg, mode, keep=True, with_values=True):
    """One filtered scan over the whole ring, paged as a shard pages it
    (``start_after`` = the last cover) until ``more`` is false.  Returns
    the pages — (n entries, more, cover, scanned rows, scanned bytes,
    partial, eval_path) — the entries if ``keep``, and the seconds."""
    pages, entries, sa = [], [], None
    t0 = time.perf_counter()
    while True:
        es, more, cover, rows, nbytes, partial, path = (
            await tree.scan_filter_page(
                0, 0, sa, None, SCAN_LIMIT, SCAN_MAX_BYTES, with_values,
                where, agg, mode,
            )
        )
        pages.append((len(es), more, cover, rows, nbytes, partial, path))
        if keep:
            entries.extend(es)
        if not more:
            return pages, entries, time.perf_counter() - t0
        sa = cover


def _check_pass(name, pages, stage, first_path):
    """Covers rise to the stage's last key, scanned rows add up to the
    stage, the first page reports ``first_path`` and every later page
    "cached" (a mask-cache hit)."""
    covers = [p[2] for p in pages]
    if any(a >= b for a, b in zip(covers, covers[1:])):
        raise AssertionError(f"scan {name}: covers do not rise")
    if covers[-1] != stage.key_at(stage.n - 1) or pages[-1][1]:
        raise AssertionError(f"scan {name}: the last page is not the end")
    rows = sum(p[3] for p in pages)
    if rows != stage.n:
        raise AssertionError(f"scan {name}: {rows} rows scanned of {stage.n}")
    paths = [p[6] for p in pages]
    want = [first_path] + ["cached"] * (len(pages) - 1)
    if first_path == "numpy":
        want = ["numpy"] * len(pages)
    if paths != want:
        raise AssertionError(f"scan {name}: eval paths {sorted(set(paths))}, "
                             f"first {paths[0]} (want {first_path})")
    return rows


async def _drive_scan(torch, np, n, device, strategy):
    from dbeel_tpu_torch import query as Q
    from dbeel_tpu_torch.ops import _cuda
    from dbeel_tpu_torch.storage import LSMTree, query_vec

    t0 = time.perf_counter()
    loads, updates = scan_docs(np, n)
    live = {}
    for key, value, ts, v in loads + updates:
        if value is None:
            live.pop(key, None)
        else:
            live[key] = (value, ts, v)
    log(f"scan: {n} docs and {len(updates)} updates generated in "
        f"{time.perf_counter() - t0:.1f}s")

    d = os.path.join(WORK, "scan")
    tree = LSMTree.open_or_create(d, strategy=strategy, device=device)
    t0 = time.perf_counter()
    for key, value, ts, _v in loads:
        await tree.set_with_timestamp(key, value, ts)
    await tree.flush()
    await _settle()
    t_load = time.perf_counter() - t0
    tables = [i for i, _ in tree.sstable_indices_and_sizes()]
    # Run scan_load: the major compaction of the loaded tables.
    _cuda.reset_launches()
    t0 = time.perf_counter()
    await tree.compact(tables, max(tables) + 1, keep_tombstones=False)
    t_compact = time.perf_counter() - t0
    load_counts = dict(_cuda.launches)
    # 60% of the updates go to newer tables, the rest stays in the
    # memtable (below its capacity), so a scan merges newest-wins
    # across the compacted table, newer tables and the memtable.
    t0 = time.perf_counter()
    for i, (key, value, ts, _v) in enumerate(updates):
        if i == len(updates) * 3 // 5:
            await tree.flush()
            await _settle()
        if value is None:
            await tree.delete_with_timestamp(key, ts)
        else:
            await tree.set_with_timestamp(key, value, ts)
    await _settle()
    layout = [(i, s) for i, s in tree.sstable_indices_and_sizes()]
    log(f"scan load: {n} docs in {t_load:.1f}s ({len(tables)} flushed "
        f"tables); major compaction {t_compact:.2f}s, launches "
        f"{load_counts}; {len(updates)} updates {time.perf_counter() - t0:.2f}s "
        f"-> tables {layout} + {tree.memtable_entries} in the memtable")
    if len(layout) < 2 or tree.memtable_entries == 0:
        raise AssertionError("updates did not land in newer tables and "
                             "the memtable")

    cut10, cut01 = n // 10, n // 1000
    lo, hi = n // 2, n // 2 + n // 10
    specs = {
        "100%": ["cmp", "v", "<", n],
        "10%": ["cmp", "v", "<", cut10],
        "0.1%": ["cmp", "v", "<", cut01],
        "range 10%": ["range", "v", lo, hi],
    }

    def expect(pred):
        return [[k, val, ts] for k, (val, ts, v) in sorted(live.items())
                if pred(v)]

    count = Q.validate_agg({"op": "count"})
    grouped = Q.validate_agg(
        {"op": "sum", "field": "v", "group": len(loads[0][0]) - 2}
    )
    col_build = []
    plain_field_column = query_vec.field_column

    def timed_field_column(stage_, name):
        if name in stage_._field_cols:
            return plain_field_column(stage_, name)
        t = time.perf_counter()
        col = plain_field_column(stage_, name)
        col_build.append(time.perf_counter() - t)
        return col

    # Run scan_filter: every query of the phase.
    query_vec.field_column = timed_field_column
    _cuda.reset_launches()
    try:
        t0 = time.perf_counter()
        stage = await tree._current_scan_stage()
        t_stage = time.perf_counter() - t0
        if stage is None or stage.n != n:
            raise AssertionError(f"stage of {stage and stage.n} rows, want {n}")
        log(f"scan stage: {stage.n} rows built in {t_stage:.2f}s")
        passes = {}
        pages, _, secs = await _scan_pass(
            tree, ["cmp", "v", ">=", 0], count, "drop", keep=False
        )
        passes["warm-up count"] = (pages, secs)
        got = sum(p[5][0] for p in pages)
        if got != len(live):
            raise AssertionError(f"warm-up count {got} != {len(live)}")
        for label, where in specs.items():
            pages, entries, secs = await _scan_pass(
                tree, where, None, "drop", keep=label != "100%"
            )
            passes[label] = (pages, secs)
            matched = sum(p[0] for p in pages)
            if label == "100%":
                ok = matched == len(live)
            elif label == "range 10%":
                ok = entries == expect(lambda v: lo <= v < hi)
            else:
                cut = where[3]
                ok = entries == expect(lambda v, c=cut: v < c)
            if not ok:
                raise AssertionError(f"scan {label}: entries differ from "
                                     f"the oracle ({matched} matched)")
        pages, _, secs = await _scan_pass(tree, None, grouped, "drop",
                                          keep=False)
        passes["grouped sum"] = (pages, secs)
        state = Q.AggState(grouped)
        for p in pages:
            state.fold_partial(p[5])
        want = {}
        for k, (_val, _ts, v) in live.items():
            g = k[: grouped["group"]]
            want[g] = want.get(g, 0) + v
        if state.result() != want:
            raise AssertionError("scan grouped sums differ from the oracle")
        pages, entries, secs = await _scan_pass(tree, specs["0.1%"], None,
                                                "mark")
        passes["0.1% mark"] = (pages, secs)
        flagged = [e[:3] for e in entries if e[3]]
        tombs = sum(1 for e in entries if e[1] == b"" and not e[3])
        if (flagged != expect(lambda v: v < cut01) or len(entries) != n
                or tombs != n - len(live)):
            raise AssertionError("scan mark pass differs from the oracle")
        t0 = time.perf_counter()
        keys, sa, n_pages = [], None, 0
        while True:
            es, more = await tree.scan_page(0, 0, sa, None, SCAN_LIMIT,
                                            SCAN_MAX_BYTES, False)
            keys.extend(e[0] for e in es if e[1] is None)
            n_pages += 1
            if not more:
                break
            sa = es[-1][0]
        t_keys = time.perf_counter() - t0
        if keys != sorted(live):
            raise AssertionError("keys-only scan differs from the oracle")
    finally:
        query_vec.field_column = plain_field_column
    counts = dict(_cuda.launches)

    first = {"warm-up count": "device", "grouped sum": "numpy",
             "0.1% mark": "cached"}
    for label, (pages, secs) in passes.items():
        rows = _check_pass(label, pages, stage, first.get(label, "device"))
        log(f"scan {label}: {len(pages)} pages {secs:.2f}s, "
            f"{rows / secs:.0f} keys scanned/s, "
            f"{sum(p[0] for p in pages)} entries, first page "
            f"{pages[0][6]}")
    log(f"scan keys-only scan_page: {n_pages} pages {t_keys:.2f}s, "
        f"{n / t_keys:.0f} keys/s")
    log(f"scan: first column build {col_build[0]:.2f}s (builds {col_build}); "
        f"launches {counts}")

    # After the counts are read: the first evaluation of a spec again
    # (stage build, column build, K8a and its copies) under the profiler.
    tree._drop_scan_stage()
    with _device_trace(torch, device) as prof:
        t0 = time.perf_counter()
        await tree.scan_filter_page(0, 0, None, None, SCAN_LIMIT,
                                    SCAN_MAX_BYTES, True, specs["10%"],
                                    None, "drop")
        wall_s = time.perf_counter() - t0
    if prof is not None:
        busy_ms, top = _device_busy(prof)
        log(f"profile: first cmp evaluation wall {wall_s * 1e3:.1f}ms "
            f"(traced), device busy {busy_ms:.3f}ms = "
            f"{busy_ms / (wall_s * 1e3):.6f} of wall; top: {top}")
    # Run scan_plane: the coordinator side of a filtered scan (a MyShard
    # answers its SCAN pages).
    plane_counts = await _scan_plane_run(tree, live, n, device)
    tree.close()
    return {"scan_load": load_counts, "scan_filter": counts,
            "scan_plane": plane_counts}


def phase_scan(torch, np, n=SCAN_DOCS, device="cuda", strategy=None):
    """Returns the launch counts of the load's compaction and of the
    filtered scans.  ``strategy`` None = the tree's default
    (get_strategy("auto") on ``device``)."""
    t0 = time.perf_counter()
    runs = asyncio.run(_drive_scan(torch, np, n, device, strategy))
    shutil.rmtree(os.path.join(WORK, "scan"))
    log(f"scan: {time.perf_counter() - t0:.1f}s")
    return runs


def check_scan_launches(runs):
    """Four K8a launches (one per cmp spec) and one K8b in the filtered
    scans, and nothing else."""
    got = runs["scan_filter"]
    want = {name: 0 for name in got}
    want.update(K8a=4, K8b=1)
    if got != want:
        raise AssertionError(f"scan_filter launches {got} (want {want})")


# ----------------------------------------------------------------------
# Phase 7: the distributed backend over a mesh of partitions
# ----------------------------------------------------------------------


def mesh_devices(torch, n_parts=MESH_PARTS):
    """Partition i on card i mod min(n_parts, cards): round-robin; with
    one card every partition shares cuda:0."""
    cards = min(n_parts, torch.cuda.device_count())
    return [torch.device("cuda", i % cards) for i in range(n_parts)]


class _MemRun:
    """An in-memory sorted run with the SSTable column interface
    (read_index_columns / read_data_bytes)."""

    def __init__(self, np, entries):
        from dbeel_tpu_torch.storage.entry import encode_entry

        self._data = b"".join(encode_entry(k, v, ts) for k, v, ts in entries)
        self._ks = np.array([len(k) for k, _, _ in entries], np.uint32)
        self._fs = np.array([16 + len(k) + len(v) for k, v, _ in entries],
                            np.uint32)
        self._offs = np.zeros(len(entries), np.uint64)
        if len(entries) > 1:
            np.cumsum(self._fs[:-1], out=self._offs[1:])

    def read_index_columns(self):
        return self._offs, self._ks, self._fs

    def read_data_bytes(self):
        return self._data


def wide_ops(np, n_ops=WIDE_OPS, n_ids=WIDE_IDS, seed=7):
    """BASELINE.json configs[3]'s writes: 16 random bytes per id, ids
    drawn with replacement, values msgpack {"v": j, "pad": "x" * L}
    with L uniform in 0-100 (the port's codec)."""
    from dbeel_tpu_torch.utils import msgpack_codec as codec

    rng = np.random.default_rng(seed)
    blob = rng.integers(0, 256, size=n_ids * 16, dtype=np.uint8).tobytes()
    ids = rng.integers(0, n_ids, size=n_ops).tolist()
    pads = rng.integers(0, 101, size=n_ops).tolist()
    return [
        (blob[i * 16: i * 16 + 16], codec.packb({"v": j, "pad": "x" * pads[j]}))
        for j, i in enumerate(ids)
    ]


def hot_runs(np, n_per_run=HOT_KEYS, seed=1):
    """__graft_entry__.py's long-key shape: 4 runs of n 24-byte keys
    plus a hot 16-byte-prefix group of n/16 keys per run."""
    rng = np.random.default_rng(seed)
    hot = bytes(rng.integers(0, 256, 16, dtype=np.uint8))
    runs = []
    for r in range(4):
        raw = rng.integers(0, 256, (n_per_run, 24), dtype=np.uint8)
        keys = {bytes(x) for x in raw}
        keys.update(
            hot + bytes(rng.integers(0, 256, 8, dtype=np.uint8))
            for _ in range(n_per_run // 16)
        )
        runs.append(_MemRun(np, [(k, b"v%d" % r, 100 + r)
                                 for k in sorted(keys)]))
    return runs


def skew_runs(np, n_per_run=SKEW_KEYS, seed=3):
    """tests/test_dist_merge.py's skew: 3 runs whose keys all share the
    first word (b"AAAA" + 12 random bytes), one timestamp."""
    rng = np.random.default_rng(seed)
    runs = []
    for _ in range(3):
        raw = rng.integers(0, 256, (n_per_run, 16), dtype=np.uint8)
        raw[:, :4] = ord("A")
        runs.append(_MemRun(np, [(k, b"v", 100)
                                 for k in sorted({bytes(x) for x in raw})]))
    return runs


def _dist_delta(before):
    from dbeel_tpu_torch.parallel import dist_merge

    return {k: dist_merge.dist_stats[k] - v for k, v in before.items()}


async def _drive_mesh_wide(np, mesh, n_ops):
    """mesh_wide and mesh_k7: one tree's 64 overlapping tables merged
    by the sample sort, then K7 on the same columns."""
    from dbeel_tpu_torch.ops import _cuda, merge
    from dbeel_tpu_torch.parallel import dist_merge
    from dbeel_tpu_torch.storage import LSMTree, columnar
    from dbeel_tpu_torch.storage.compaction import get_strategy
    from dbeel_tpu_torch.storage.entry import (
        COMPACT_BLOOM_FILE_EXT, COMPACT_DATA_FILE_EXT, COMPACT_INDEX_FILE_EXT,
        file_name,
    )
    from dbeel_tpu_torch.storage.sstable import SSTable

    t0 = time.perf_counter()
    ops = wide_ops(np, n_ops)
    log(f"mesh_wide: {len(ops)} ops generated in "
        f"{time.perf_counter() - t0:.1f}s")
    d = os.path.join(WORK, "mesh", "wide")
    strategy = dist_merge.DistributedMergeStrategy(mesh)
    tree = LSMTree.open_or_create(d, strategy=strategy)
    oracle = {}
    t0 = time.perf_counter()
    for j, (key, value) in enumerate(ops):
        await tree.set_with_timestamp(key, value, 1_000 + j)
        oracle[key] = value
    await tree.flush()
    await _settle()
    t_write = time.perf_counter() - t0
    layout = tree.sstable_indices_and_sizes()
    tables = [i for i, _ in layout]
    size = sum(sz for _, sz in layout)
    ref = os.path.join(WORK, "mesh", "wide_ref")
    shutil.copytree(d, ref, ignore=shutil.ignore_patterns("*.memtable"))
    log(f"mesh_wide: {len(ops)} writes in {t_write:.1f}s "
        f"({len(ops) / t_write:.0f} ops/s), {len(tables)} tables, "
        f"{size} bytes")
    if size >= strategy.PIPELINE_MIN_BYTES:
        raise AssertionError("mesh_wide is not under PIPELINE_MIN_BYTES")

    # Run mesh_wide: the major compaction on the mesh.
    out_index = max(tables) + 1
    before = dict(dist_merge.dist_stats)
    _cuda.reset_launches()
    t0 = time.perf_counter()
    await tree.compact(tables, out_index, keep_tombstones=False)
    t_compact = time.perf_counter() - t0
    counts = dict(_cuda.launches)
    delta = _dist_delta(before)
    log(f"mesh_wide: compaction of {len(tables)} tables on the mesh "
        f"{t_compact:.2f}s; dist_stats {delta}; launches {counts}")
    if delta != {"runs": 1, "fallbacks": 0, "overflow_rows": 0}:
        raise AssertionError(f"mesh_wide did not run the sample sort: {delta}")

    # The cpu strategy's merge of the copy, file by file.
    srcs = [SSTable(ref, i, None) for i in tables]
    cols = columnar.load_columns(srcs)
    t0 = time.perf_counter()
    get_strategy("cpu").merge(srcs, ref, out_index, None, False,
                              tree.bloom_min_size)
    t_cpu = time.perf_counter() - t0
    for t in srcs:
        t.close()
    got, want = _table_digests(d), _table_digests(ref)
    for ext, cext in (("data", COMPACT_DATA_FILE_EXT),
                      ("index", COMPACT_INDEX_FILE_EXT),
                      ("bloom", COMPACT_BLOOM_FILE_EXT)):
        if got.get(file_name(out_index, ext)) != want.get(
                file_name(out_index, cext)):
            raise AssertionError(f"mesh_wide: {ext} differs from the cpu merge")
    log(f"mesh_wide: .data/.index/.bloom SHA-256-equal to the cpu merge "
        f"({t_cpu:.2f}s)")

    rng = np.random.default_rng(7)
    keys = list(oracle)
    probe = [keys[int(i)] for i in rng.integers(0, len(keys), size=20000)]
    probe += [b"absent-%09d" % i for i in range(1000)]
    t0 = time.perf_counter()
    bad = 0
    for key in probe:
        if await tree.get(key) != oracle.get(key):
            bad += 1
    log(f"mesh_wide: {len(probe)} oracle gets {time.perf_counter() - t0:.1f}s,"
        f" mismatches {bad}")
    tree.close()
    if bad:
        raise AssertionError(f"mesh_wide: {bad} gets disagree with the oracle")

    # Run mesh_k7: K7 on the same columns, then the mesh and numpy.
    _cuda.reset_launches()
    t0 = time.perf_counter()
    perm7, same7 = merge.device_sort_dedup(cols, mesh.devices[0])
    t_k7 = time.perf_counter() - t0
    k7_counts = dict(_cuda.launches)
    # The mesh's sort of the same columns, traced (after the counts).
    import torch

    with _device_trace(torch, mesh.devices[0]) as prof:
        t0 = time.perf_counter()
        perm_d, same_d = dist_merge.distributed_sort_dedup(cols, mesh)
        t_sort = time.perf_counter() - t0
    if prof is not None:
        busy_ms, top = _device_busy(prof)
        log(f"profile: mesh sort of the wide columns wall "
            f"{t_sort * 1e3:.1f}ms (traced), device busy {busy_ms:.2f}ms = "
            f"{busy_ms / (t_sort * 1e3):.4f} of wall; top: {top}")
    perm_np = columnar.sort_columns_numpy(cols)
    keep_np = columnar.dedup_mask(cols, perm_np)
    ok = (np.array_equal(perm7, perm_d) and np.array_equal(same7, same_d)
          and np.array_equal(perm7, perm_np) and np.array_equal(~same7, keep_np))
    log(f"mesh_k7: device_sort_dedup of {len(cols)} rows {t_k7:.3f}s end to "
        f"end; (perm, same) equal to the mesh and to numpy: {ok}; launches "
        f"{k7_counts}")
    if not ok:
        raise AssertionError("mesh_k7: K7 disagrees with the mesh or numpy")
    shutil.rmtree(os.path.join(WORK, "mesh"))
    return {"mesh_wide": counts, "mesh_k7": k7_counts}


def _mesh_sort(np, mesh, name, runs):
    """One counted distributed_sort_dedup over in-memory runs; returns
    its columns, (perm, same), launch counts and dist_stats delta."""
    from dbeel_tpu_torch.ops import _cuda
    from dbeel_tpu_torch.parallel import dist_merge
    from dbeel_tpu_torch.storage import columnar

    cols = columnar.load_columns(runs)
    before = dict(dist_merge.dist_stats)
    _cuda.reset_launches()
    t0 = time.perf_counter()
    perm, same = dist_merge.distributed_sort_dedup(cols, mesh)
    secs = time.perf_counter() - t0
    counts = dict(_cuda.launches)
    delta = _dist_delta(before)
    log(f"{name}: {len(cols)} rows sorted in {secs:.3f}s; dist_stats "
        f"{delta}; launches {counts}")
    return cols, perm, same, counts, delta


def mesh_hot(np, mesh, n_per_run=HOT_KEYS):
    from dbeel_tpu_torch.storage import columnar

    cols, perm, _same, counts, delta = _mesh_sort(
        np, mesh, "mesh_hot", hot_runs(np, n_per_run)
    )
    if delta != {"runs": 1, "fallbacks": 0, "overflow_rows": 0}:
        raise AssertionError(f"mesh_hot overflowed: {delta}")
    perm = columnar.fixup_long_key_ties(cols, perm)
    perm_np = columnar.fixup_long_key_ties(
        cols, columnar.sort_columns_numpy(cols)
    )
    if not (np.array_equal(perm, perm_np) and np.array_equal(
            columnar.dedup_mask(cols, perm), columnar.dedup_mask(cols, perm_np))):
        raise AssertionError("mesh_hot: differs from numpy after the fix-up")
    return counts


def mesh_skew(np, mesh, n_per_run=SKEW_KEYS):
    from dbeel_tpu_torch.ops import bitonic
    from dbeel_tpu_torch.storage import columnar

    seen = []
    real = bitonic.merge_runs_perm_kernel

    def spy(stacks):
        seen.append(stacks.device)
        return real(stacks)

    bitonic.merge_runs_perm_kernel = spy
    try:
        cols, perm, same, counts, delta = _mesh_sort(
            np, mesh, "mesh_skew", skew_runs(np, n_per_run)
        )
    finally:
        bitonic.merge_runs_perm_kernel = real
    if delta["fallbacks"] != 1 or delta["overflow_rows"] <= 0 or delta["runs"]:
        raise AssertionError(f"mesh_skew did not fall back once: {delta}")
    if seen != [mesh.devices[0]]:
        raise AssertionError(f"mesh_skew: K4 ran on {seen}, want "
                             f"[{mesh.devices[0]}]")
    perm_np = columnar.sort_columns_numpy(cols)
    if not (np.array_equal(perm, perm_np)
            and np.array_equal(~same, columnar.dedup_mask(cols, perm_np))):
        raise AssertionError("mesh_skew: differs from numpy")
    return counts


def mesh_big(torch, np, mesh, bench, bench_keys=BENCH_KEYS):
    """Phase 3's runs through the mesh pipeline.  ``bench`` — phase 3's
    runs, digest and rate; None (``--only mesh``) builds ``bench_keys``
    docs of runs and takes the device strategy's merge on the first
    partition's device as the reference."""
    from dbeel_tpu_torch.ops import bitonic, pipeline
    from dbeel_tpu_torch.parallel import dist_merge
    from dbeel_tpu_torch.storage.compaction import get_strategy

    if bench is None:
        d = os.path.join(WORK, "bench")
        os.makedirs(d)
        idx = build_bench_runs(np, d, bench_keys, 8)
        rate, n, sha, _ = _merge(
            get_strategy("device", device=mesh.devices[0]), d, idx, 101
        )
        bench = dict(dir=d, idx=idx, sha=sha, n=n, rate=rate)
    slots = []
    real1 = bitonic.merge_runs_prefix32_packed_batch_kernel
    real2 = bitonic.merge_runs_prefix64_packed_batch_kernel

    def spy(real):
        def launch(operand, counts, pack_bits):
            slots.append((operand.shape[0], operand.device))
            return real(operand, counts, pack_bits)
        return launch

    strategy = dist_merge.DistributedMergeStrategy(mesh)
    runs_before = pipeline.pipeline_stats["runs"]
    bitonic.merge_runs_prefix32_packed_batch_kernel = spy(real1)
    bitonic.merge_runs_prefix64_packed_batch_kernel = spy(real2)
    try:
        (rate, n, sha, secs), counts = _main_path_run(
            lambda: _merge(strategy, bench["dir"], bench["idx"], 107)
        )
    finally:
        bitonic.merge_runs_prefix32_packed_batch_kernel = real1
        bitonic.merge_runs_prefix64_packed_batch_kernel = real2
    shutil.rmtree(bench["dir"])
    log(f"mesh_big: {n} entries through the mesh pipeline in {secs:.2f}s "
        f"({rate:.0f} keys/s; one card's pipeline {bench['rate']:.0f} keys/s "
        f"in this run), sha256 equal: {sha == bench['sha']}; launch slots "
        f"(J, device) {sorted(set((j, str(dv)) for j, dv in slots))} x "
        f"{len(slots)}; launches {counts}")
    if pipeline.pipeline_stats["runs"] == runs_before:
        raise AssertionError("mesh_big did not run the pipeline")
    if (n, sha) != (bench["n"], bench["sha"]):
        raise AssertionError("mesh_big output differs from the host merge")
    if not slots or {j for j, _ in slots} != {1} or (
            {dv for _, dv in slots} != set(mesh.devices)):
        raise AssertionError(f"mesh_big: launches not one slot per "
                             f"partition on its device: {slots}")
    return counts


def phase_mesh(torch, np, bench=None, devices=None, n_ops=WIDE_OPS,
               hot_keys=HOT_KEYS, skew_keys=SKEW_KEYS, bench_keys=BENCH_KEYS):
    """Returns the launch counts of the mesh phase's runs.  ``devices``
    None = mesh_devices(torch); ``[cpu] * 4`` with small sizes (and
    DistributedMergeStrategy.PIPELINE_MIN_BYTES lowered) rehearses it
    on the CPU."""
    from dbeel_tpu_torch.parallel.mesh import shard_mesh

    t0 = time.perf_counter()
    mesh = shard_mesh(devices=devices or mesh_devices(torch))
    log(f"mesh: {mesh.size} partitions on {len(set(mesh.devices))} "
        f"device(s), placement {[str(dv) for dv in mesh.devices]}")
    runs = asyncio.run(_drive_mesh_wide(np, mesh, n_ops))
    runs["mesh_hot"] = mesh_hot(np, mesh, hot_keys)
    runs["mesh_skew"] = mesh_skew(np, mesh, skew_keys)
    runs["mesh_big"] = mesh_big(torch, np, mesh, bench, bench_keys)
    log(f"mesh: {time.perf_counter() - t0:.1f}s")
    return runs


def check_mesh_launches(runs):
    """mesh_wide, mesh_hot: K5 x8, K9b x4 and nothing else (the
    splitter pick runs inside K9b's launch); mesh_k7: K7 x1; mesh_skew:
    the same plus K4 x1; mesh_big: K1/K2 only, a multiple of the
    partition count."""
    sort = {"K5": 2 * MESH_PARTS, "K9b": MESH_PARTS}
    for name, extra in (("mesh_wide", {}), ("mesh_hot", {}),
                        ("mesh_skew", {"K4": 1}), ("mesh_k7", None)):
        got = runs[name]
        want = {k: 0 for k in got}
        want.update({"K7": 1} if extra is None else dict(sort, **extra))
        if got != want:
            raise AssertionError(f"{name} launches {got} (want {want})")
    big = runs["mesh_big"]
    rest = {k: v for k, v in big.items() if k not in ("K1", "K2")}
    merges = big["K1"] + big["K2"]
    if big["K1"] == 0 or any(rest.values()) or merges % MESH_PARTS:
        raise AssertionError(f"mesh_big launches {big}")


# ----------------------------------------------------------------------
# Phase 8: one shard as the server's defaults build it
# ----------------------------------------------------------------------


def _io_uring_refusal() -> str:
    """Why the host gave no io_uring ring, for the log."""
    try:
        with open("/proc/sys/kernel/io_uring_disabled") as f:
            why = f"kernel.io_uring_disabled={f.read().strip()}"
    except OSError:
        why = "no kernel.io_uring_disabled"
    return (f"io_uring refused on this host, kernel {os.uname().release}, "
            f"{why}")


def _timed_native_flushes(tree):
    """Wrap the tree's native flush to record each one's seconds (the
    flushes run on executor threads)."""
    took, inner = [], tree._native_flush

    def timed(memtable, index):
        t0 = time.perf_counter()
        inner(memtable, index)
        took.append(time.perf_counter() - t0)

    tree._native_flush = timed
    return took


async def _durable_leg(np, d, n_writes, n_writers, tree_kw):
    """Durable writes from concurrent tasks into a wal_sync tree: acks
    wait on the native group commit — the io_uring sync hub wherever
    the host lets it create a ring, else the C sync thread.  Returns the
    backend, writes/s, the syncs it took, the acknowledged writes and
    those the closed WAL lost."""
    from dbeel_tpu_torch.storage import LSMTree, native
    from dbeel_tpu_torch.storage import wal as wal_mod

    hub = wal_mod._SyncHub.get(native.load())
    if hub is not None:
        backend = "io_uring sync hub"
    else:
        backend = ("C sync thread (dbeel_walsync_hub_new gave no ring: "
                   f"{_io_uring_refusal()})")
    # Room for every write in one memtable and its one WAL.
    tree = LSMTree.open_or_create(
        d, capacity=2 * n_writes, wal_sync=True, wal_sync_delay_us=200,
        memtable_kind="auto", **tree_kw,
    )
    syncer = tree._wal._syncer
    if (tree.memtable_kind != "arena" or syncer is None
            or (syncer._hub is None) != (hub is None)):
        raise AssertionError(
            f"durable tree: memtable {tree.memtable_kind}, syncer "
            f"{syncer}, hub {getattr(syncer, '_hub', None)} (a ring "
            f"{'can' if hub is not None else 'cannot'} be created)"
        )
    rng = np.random.default_rng(8)
    per = n_writes // n_writers
    values = rng.integers(0, 256, size=(n_writers * per, 64), dtype=np.uint8)
    acked = []

    async def writer(w):
        for j in range(per):
            i = w * per + j
            key, value = b"dur%03d-%09d" % (w, j), values[i].tobytes()
            await tree.set_with_timestamp(key, value, 1_000 + i)
            acked.append((key, value, 1_000 + i))

    syncs0 = wal_mod.group_commit_stats()["syncs"]
    t0 = time.perf_counter()
    await asyncio.gather(*(writer(w) for w in range(n_writers)))
    rate = len(acked) / (time.perf_counter() - t0)
    syncs = wal_mod.group_commit_stats()["syncs"] - syncs0
    wal = tree._wal
    tree.close()
    # The syncer's close handshake completes on the loop.
    for _ in range(500):
        if wal._fd < 0:
            break
        await asyncio.sleep(0.01)
    replayed = {k: (v, ts) for k, v, ts in wal_mod.replay(wal.path)}
    lost = sum(replayed.get(k) != (v, ts) for k, v, ts in acked)
    return backend, rate, syncs, len(acked), lost


async def _drive_arena(torch, np, n_ops, n_durable, n_writers, device):
    from dbeel_tpu_torch.ops import bitonic as B
    from dbeel_tpu_torch.storage import DEFAULT_TREE_CAPACITY, LSMTree, native
    from dbeel_tpu_torch.storage.compaction import (
        compaction_stats,
        get_strategy,
    )
    from dbeel_tpu_torch.storage.entry import file_name
    from dbeel_tpu_torch.storage.page_cache import (
        PageCache, PartitionPageCache,
    )

    ops = shard_ops(np, 0, n_ops, overwrites=0.01, deletes=0.005)
    oracle = dict(ops)
    # The tree as a shard opens it: default capacity, memtable "auto"
    # and no strategy (get_strategy("auto") on ``device``).  On several
    # cards auto is the mesh; the phase holds the one-card route there.
    dev = torch.device(device)
    tree_kw = {"device": device}
    if dev.type == "cuda" and torch.cuda.device_count() > 1:
        tree_kw["strategy"] = get_strategy("device")
    d = os.path.join(WORK, "arena", "tree")
    tree = LSMTree.open_or_create(
        d, cache=PartitionPageCache("arena", PageCache(16384)),
        capacity=DEFAULT_TREE_CAPACITY, memtable_kind="auto", **tree_kw,
    )
    if tree.memtable_kind != "arena" or tree.strategy.name != "device" \
            or tree.strategy.device.type != dev.type:
        raise AssertionError(
            f"arena tree: memtable {tree.memtable_kind}, strategy "
            f"{tree.strategy.name} on {tree.strategy.device}"
        )
    flush_s = _timed_native_flushes(tree)
    before = compaction_stats.stats()
    t0 = time.perf_counter()
    await _write_tree(tree, ops)
    await tree.flush()
    await _settle()
    t_write = time.perf_counter() - t0
    after = compaction_stats.stats()
    tables = [i for i, _ in tree.sstable_indices_and_sizes()]
    delta = {k: after[k] - before[k]
             for k in ("flush_passes", "sidecar_inline", "sidecar_posthoc")}
    log(f"arena write: {n_ops} ops in {t_write:.1f}s "
        f"({n_ops / t_write:.0f} writes/s), {len(tables)} native flushes "
        f"of {DEFAULT_TREE_CAPACITY} entries, flush seconds total "
        f"{sum(flush_s):.3f} mean {sum(flush_s) / max(1, len(flush_s)):.4f} "
        f"max {max(flush_s, default=0):.4f}; compaction stats {delta}")
    if not (delta["flush_passes"] == delta["sidecar_inline"] == len(flush_s)
            == len(tables)) or delta["sidecar_posthoc"]:
        raise AssertionError(
            f"flushes not all native and single-pass: {delta}, "
            f"{len(flush_s)} native, {len(tables)} tables"
        )

    # The sorted-memtable twin flushes the same tables.
    t0 = time.perf_counter()
    twin_dir = os.path.join(WORK, "arena", "twin")
    twin = LSMTree.open_or_create(
        twin_dir, capacity=DEFAULT_TREE_CAPACITY, memtable_kind="sorted",
        strategy=get_strategy("cpu"),
    )
    await _write_tree(twin, ops)
    await twin.flush()
    await _settle()
    same_flushes = _table_digests(d) == _table_digests(twin_dir)
    log(f"arena twin: sorted memtable {time.perf_counter() - t0:.1f}s, "
        f"flushed tables SHA-256-equal: {same_flushes}")
    if not same_flushes:
        raise AssertionError("arena and sorted memtables flushed differently")

    # Run arena_compact: one major compaction on the card.
    out = max(tables) + 1
    B.reset_launches()
    t0 = time.perf_counter()
    await tree.compact(tables, out, keep_tombstones=False)
    counts = dict(B.launches)
    t_compact = time.perf_counter() - t0
    await twin.compact(tables, out, keep_tombstones=False)
    digests = [
        {ext: _table_digests(x).get(file_name(out, ext))
         for ext in ("data", "index", "bloom", "sums")}
        for x in (d, twin_dir)
    ]
    log(f"arena compact: {len(tables)} tables in {t_compact:.2f}s, "
        f"launches {counts}; SHA-256 equal to the sorted twin's cpu merge: "
        f"{digests[0] == digests[1]}")
    if digests[0] != digests[1] or digests[0]["data"] is None:
        raise AssertionError(f"compacted tables differ: {digests}")
    twin.close()

    t0 = time.perf_counter()
    probe = list(oracle) + [b"absent-%09d" % i for i in range(10000)]
    bad = 0
    for key in probe:
        if await tree.get(key) != oracle.get(key):
            bad += 1
    log(f"arena gets: {len(probe)} oracle gets in "
        f"{time.perf_counter() - t0:.1f}s, mismatches {bad}")
    tree.close()
    if bad:
        raise AssertionError(f"{bad} arena gets disagree with the oracle")

    backend, rate, syncs, n_acked, lost = await _durable_leg(
        np, os.path.join(WORK, "arena", "durable"), n_durable, n_writers,
        tree_kw,
    )
    log(f"arena durable: group commit through the {backend}; "
        f"{n_acked} writes from {n_writers} tasks "
        f"{rate:.0f} writes/s, {syncs} group-commit syncs "
        f"({syncs / max(1, n_acked):.4f} a write), lost after close {lost}; "
        f"odirect_fallbacks {native.odirect_fallbacks()}, "
        f"read_overlap_stats {native.read_overlap_stats()}")
    if syncs >= n_acked or lost:
        raise AssertionError(
            f"durable leg: {syncs} syncs for {n_acked} writes, {lost} lost"
        )
    return {"arena_compact": counts}


def phase_arena(torch, np, n_ops=ARENA_OPS, n_durable=ARENA_DURABLE,
                n_writers=ARENA_WRITERS, device="cuda"):
    """Returns the launch counts of the arena tree's major compaction."""
    t0 = time.perf_counter()
    runs = asyncio.run(
        _drive_arena(torch, np, n_ops, n_durable, n_writers, device)
    )
    shutil.rmtree(os.path.join(WORK, "arena"))
    log(f"arena: {time.perf_counter() - t0:.1f}s")
    return runs


def check_arena_launches(runs):
    """The arena tree's compaction (< 64 MiB) takes K3's single-shot
    route (K4 where prefixes tie) and no other kernel."""
    got = runs["arena_compact"]
    rest = {k: v for k, v in got.items() if k not in ("K3", "K4")}
    if got.get("K3", 0) == 0 or any(rest.values()):
        raise AssertionError(f"arena_compact launches {got}")


# ----------------------------------------------------------------------
# Phase 9: one shard's indexed collection
# ----------------------------------------------------------------------


def index_docs(n, seed=7):
    """blackbox_bench.py --scan-filter-indexed's collection: keys
    msgpack("key-%08d"), documents {"v": j, "blob": "x" * 100} at
    timestamp 1000 + j, written in an order shuffled from ``seed``.
    Returns (keys, values, order), keys and values indexed by j."""
    import random

    from dbeel_tpu_torch.utils import msgpack_codec as codec

    blob = "x" * 100
    keys = [codec.packb("key-%08d" % j) for j in range(n)]
    values = [codec.packb({"v": j, "blob": blob}) for j in range(n)]
    order = list(range(n))
    random.Random(seed).shuffle(order)
    return keys, values, order


async def _cold_gets(tree, keys, values, picks):
    """Point gets of ``picks`` on a tree whose page cache is empty,
    counting the page reads that completed through io_uring and those
    the executor took.  Returns (mismatches, seconds, ring reads,
    executor reads, why no ring)."""
    from dbeel_tpu_torch.storage import file_io, uring

    ur = uring.get_for_loop()
    why = (None if ur is not None else
           f"dbeel_uring_create gave no ring: {_io_uring_refusal()}")
    ring_done, hops = [0], [0]
    real_queue = uring.UringReader.queue_pread
    real_pread = file_io.CachedFileReader._pread_pages

    def done(fut):
        if not fut.cancelled() and fut.exception() is None:
            ring_done[0] += 1

    def queue(self, fd, size, offset):
        fut = real_queue(self, fd, size, offset)
        if fut is not None:
            fut.add_done_callback(done)
        return fut

    def pread(self, addresses):
        hops[0] += len(addresses)
        return real_pread(self, addresses)

    uring.UringReader.queue_pread = queue
    file_io.CachedFileReader._pread_pages = pread
    try:
        bad = 0
        t0 = time.perf_counter()
        for j in picks:
            if await tree.get(keys[j]) != values[j]:
                bad += 1
        secs = time.perf_counter() - t0
    finally:
        uring.UringReader.queue_pread = real_queue
        file_io.CachedFileReader._pread_pages = real_pread
    if ur is not None and ring_done[0] == 0:
        raise AssertionError("a ring was made but no read completed on it")
    if ur is None and hops[0] == 0:
        raise AssertionError(f"no ring ({why}) and no executor read")
    return bad, secs, ring_done[0], hops[0], why


async def _drive_index(torch, np, n, capacity, tier, n_gets, device,
                       strategy):
    from dbeel_tpu_torch import query as Q
    from dbeel_tpu_torch.ops import _cuda, pipeline
    from dbeel_tpu_torch.ops.device_compaction import DeviceMergeStrategy
    from dbeel_tpu_torch.storage import LSMTree
    from dbeel_tpu_torch.storage import secondary_index as si
    from dbeel_tpu_torch.storage.compaction import compaction_stats
    from dbeel_tpu_torch.storage.page_cache import (
        PageCache, PartitionPageCache,
    )

    t0 = time.perf_counter()
    keys, values, order = index_docs(n)
    log(f"index: {n} docs generated in {time.perf_counter() - t0:.1f}s")
    d = os.path.join(WORK, "index")

    def open_tree():
        # A fresh page cache each time: the gets after a reopen are cold.
        return LSMTree.open_or_create(
            d, cache=PartitionPageCache("index", PageCache(16384)),
            capacity=capacity, memtable_kind="auto", index_fields=["v"],
            strategy=strategy, device=device,
        )

    tree = open_tree()
    if tree.memtable_kind != "arena" or tree.index_fields != ["v"]:
        raise AssertionError(f"index tree: memtable {tree.memtable_kind}, "
                             f"index_fields {tree.index_fields}")
    flush_s = _timed_native_flushes(tree)
    idx0, st0 = si.index_stats.stats(), compaction_stats.stats()
    t0 = time.perf_counter()
    for j in order:
        await tree.set_with_timestamp(keys[j], values[j], 1_000 + j)
    await tree.flush()
    await _settle()
    t_load = time.perf_counter() - t0
    tables = [i for i, _ in tree.sstable_indices_and_sizes()]
    idx1, st1 = si.index_stats.stats(), compaction_stats.stats()
    missing = [i for i in tables
               if not all(os.path.exists(p) for p in si.run_paths(d, i))]
    built = idx1["runs_built"] - idx0["runs_built"]
    log(f"index load: {n} writes in {t_load:.1f}s ({n / t_load:.0f} "
        f"writes/s), {len(tables)} native flushes (seconds total "
        f"{sum(flush_s):.3f}, mean {sum(flush_s) / max(1, len(flush_s)):.4f},"
        f" max {max(flush_s, default=0):.4f}); {built} runs built, "
        f"{idx1['bytes_written'] - idx0['bytes_written']} run bytes")
    if missing or built != len(tables) or len(flush_s) != len(tables):
        raise AssertionError(f"flushes without a .fidx run and its sidecar: "
                             f"{missing}; {built} built, {len(flush_s)} "
                             f"native flushes of {len(tables)} tables")

    # Run index_tiered: size-tiered merges of ``tier`` flushed tables,
    # each under the pipeline's threshold (single-shot K3, K4 on ties).
    sizes = dict(tree.sstable_indices_and_sizes())
    groups = [tables[i: i + tier] for i in range(0, len(tables), tier)]
    top = max(sum(sizes[i] for i in g) for g in groups)
    if top >= DeviceMergeStrategy.PIPELINE_MIN_BYTES:
        raise AssertionError(f"a tier of {top} bytes takes the pipeline")
    _cuda.reset_launches()
    t0 = time.perf_counter()
    for g in groups:
        await tree.compact(g, max(g) + 1, keep_tombstones=True)
    tiered = dict(_cuda.launches)
    t_tiered = time.perf_counter() - t0
    st2, idx2 = compaction_stats.stats(), si.index_stats.stats()
    outs = [max(g) + 1 for g in groups]
    live = [i for i, _ in tree.sstable_indices_and_sizes()]
    extra = ((st2["bytes_read"] - st1["bytes_read"])
             - (st2["merge_input_bytes"] - st1["merge_input_bytes"]))
    stale = [i for i in tables for p in si.run_paths(d, i)
             if os.path.exists(p)]
    log(f"index tiered: {len(groups)} merges of up to {tier} tables "
        f"({top} bytes at most) in {t_tiered:.2f}s, launches {tiered}; "
        f"{idx2['runs_merged'] - idx1['runs_merged']} runs merged, extra "
        f"data reads {extra} bytes")
    if live != outs or extra or stale or any(
            si.load_run(d, o) is None for o in outs):
        raise AssertionError(
            f"tiered merges: live {live} (want {outs}), extra reads "
            f"{extra}, input runs left {stale}")

    # The selectivity sweep: each spec paged with the index and, on the
    # same tree, without it, each side from a fresh stage.
    cut = {frac: max(1, int(n * frac)) for frac in (0.001, 0.01, 0.1)}
    lo, hi = n // 2, n // 2 + cut[0.01]
    count = Q.validate_agg({"op": "count"})
    specs = [
        ("0.1%", ["cmp", "v", "<", cut[0.001]], None, range(cut[0.001])),
        ("1%", ["cmp", "v", "<", cut[0.01]], None, range(cut[0.01])),
        ("10%", ["cmp", "v", "<", cut[0.1]], None, range(cut[0.1])),
        ("and 1%", ["and", ["cmp", "v", ">=", lo], ["cmp", "v", "<", hi]],
         None, range(lo, hi)),
        ("count 1%", ["cmp", "v", "<", cut[0.01]], count, range(cut[0.01])),
    ]

    async def warm():
        await tree.scan_filter_page(0, 0, None, None, 1, 1 << 16, True,
                                    None, None, "drop")

    hits0 = si.index_stats.stats()["planner_hits"]
    for label, where, agg, want in specs:
        where = Q.validate_where(where)
        sides = {}
        for indexed in (True, False):
            tree.index_fields = ["v"] if indexed else None
            tree._drop_scan_stage()
            await warm()
            pages, entries, secs = await _scan_pass(tree, where, agg, "drop")
            sides[indexed] = (pages, entries, secs)
        tree.index_fields = ["v"]
        tree._drop_scan_stage()
        (ip, ie, isecs), (sp, se, ssecs) = sides[True], sides[False]
        paths = sorted({p[6] for p in ip})
        oracle = [[keys[j], values[j], 1_000 + j] for j in want]
        folded = []
        for side in (ip, sp):
            state = Q.AggState(agg) if agg is not None else None
            for p in side:
                if state is not None:
                    state.fold_partial(p[5])
            folded.append(state and state.result())
        ok = ie == oracle if agg is None else (
            not ie and folded[0] == len(want))
        same = (ie == se and folded[0] == folded[1]
                and [p[2:5] for p in ip] == [p[2:5] for p in sp])
        log(f"index {label}: indexed {len(ip)} pages {isecs:.3f}s "
            f"({len(want) / isecs:.0f} keys-matched/s, paths {paths}) | "
            f"scan-everything {ssecs:.3f}s ({len(want) / ssecs:.0f} "
            f"keys-matched/s) -> x{ssecs / isecs:.2f}; byte-identical "
            f"{same}, oracle {ok}")
        if "indexed" not in paths or not same or not ok:
            raise AssertionError(f"index {label}: paths {paths}, "
                                 f"byte-identical {same}, oracle {ok}")
    stats = si.index_stats.stats()
    amp = compaction_stats.stats()["index_maintenance_amplification"]
    log(f"index stats {json.dumps(stats, sort_keys=True)}; "
        f"index_maintenance_amplification {amp}")
    if stats["planner_hits"] <= hits0:
        raise AssertionError("the planner never engaged")

    # Cold point reads: a reopened tree with an empty page cache.
    tree.close()
    tree = open_tree()
    picks = np.random.default_rng(9).choice(n, n_gets, replace=False)
    bad, secs, ring, hops, why = await _cold_gets(
        tree, keys, values, picks.tolist())
    log(f"index cold gets: {n_gets} in {secs:.2f}s ({n_gets / secs:.0f} "
        f"gets/s), mismatches {bad}; page reads through io_uring {ring}, "
        f"through the executor {hops}"
        + ("" if why is None else f" ({why})"))
    if bad:
        raise AssertionError(f"{bad} cold gets disagree with the oracle")

    # Run index_major: one major compaction over the pipeline's
    # threshold — the pipeline (K1) writes no index run, as in
    # dbeel_tpu, and the planner then misses on the output.
    live = [i for i, _ in tree.sstable_indices_and_sizes()]
    total = sum(s for _, s in tree.sstable_indices_and_sizes())
    if total < DeviceMergeStrategy.PIPELINE_MIN_BYTES:
        raise AssertionError(f"the major compaction of {total} bytes is "
                             "under the pipeline's threshold")
    out = max(live) + 1
    runs0 = pipeline.pipeline_stats["runs"]
    _cuda.reset_launches()
    t0 = time.perf_counter()
    await tree.compact(live, out, keep_tombstones=False)
    major = dict(_cuda.launches)
    t_major = time.perf_counter() - t0
    left = [p for c in (False, True) for p in si.run_paths(d, out, c)
            if os.path.exists(p)]
    log(f"index major: {len(live)} tables ({total} bytes) in "
        f"{t_major:.2f}s through the pipeline "
        f"({pipeline.pipeline_stats['runs'] - runs0} run), launches "
        f"{major}; index run files on the output {left}")
    if pipeline.pipeline_stats["runs"] != runs0 + 1 or left:
        raise AssertionError(f"major compaction: pipeline runs "
                             f"{pipeline.pipeline_stats}, run files {left}")
    misses0 = si.index_stats.stats()["planner_misses"]
    label, where, _agg, want = specs[0]
    pages, entries, secs = await _scan_pass(
        tree, Q.validate_where(where), None, "drop")
    paths = sorted({p[6] for p in pages})
    ok = entries == [[keys[j], values[j], 1_000 + j] for j in want]
    log(f"index {label} after the major compaction: {len(pages)} pages "
        f"{secs:.3f}s, paths {paths}, oracle {ok}")
    if ("indexed" in paths or not ok
            or si.index_stats.stats()["planner_misses"] <= misses0):
        raise AssertionError(f"scan after the major compaction: paths "
                             f"{paths}, oracle {ok}")
    tree.close()
    return {"index_tiered": tiered, "index_major": major}


def phase_index(torch, np, n=INDEX_DOCS, capacity=INDEX_CAPACITY,
                tier=INDEX_TIER, n_gets=INDEX_GETS, device="cuda",
                strategy=None):
    """Returns the launch counts of the tiered merges and of the major
    compaction.  ``strategy`` None = get_strategy("device") on
    ``device``."""
    from dbeel_tpu_torch.storage.compaction import get_strategy

    t0 = time.perf_counter()
    runs = asyncio.run(_drive_index(
        torch, np, n, capacity, tier, n_gets, device,
        strategy or get_strategy("device", device=device),
    ))
    shutil.rmtree(os.path.join(WORK, "index"))
    log(f"index: {time.perf_counter() - t0:.1f}s")
    return runs


def check_index_launches(runs):
    """The tiered merges take K3's single-shot route (K4 where prefixes
    tie), the major compaction the pipeline (K1, K2 for dense
    partitions), and nothing else."""
    for run, want, allowed in (("index_tiered", "K3", ("K3", "K4")),
                               ("index_major", "K1", ("K1", "K2"))):
        got = runs[run]
        rest = {k: v for k, v in got.items() if k not in allowed}
        if got.get(want, 0) == 0 or any(rest.values()):
            raise AssertionError(f"{run} launches {got}")


# ----------------------------------------------------------------------
# Phase 10: the share scheduler throttling a merge on the card
# ----------------------------------------------------------------------

# Foreground cadence of the busy run: one request every 10 ms.
PLANES_MARK_S = 0.01


def _fg_marks(scheduler, stop):
    """Foreground traffic from another thread: fg_mark() every
    PLANES_MARK_S until ``stop`` is set."""
    while not stop.wait(PLANES_MARK_S):
        scheduler.fg_mark()


async def _throttled_unit(scheduler, strategy, d, idx, out_index):
    """One background unit as a shard runs a compaction: the merge in
    an executor thread inside scheduler.bg_slice(), the strategy's
    throttle from scheduler.thread_throttle() (dbeel_tpu/server/
    shard.py:833).  Returns _merge_only's result and the unit's wall
    seconds (the merge, its ticks' sleeps and the slice's payback)."""
    loop = asyncio.get_running_loop()
    strategy.throttle = scheduler.thread_throttle()
    try:
        t0 = time.perf_counter()
        async with scheduler.bg_slice():
            result = await loop.run_in_executor(
                None, _merge_only, strategy, d, idx, out_index
            )
        return result, time.perf_counter() - t0
    finally:
        strategy.throttle = None


def phase_planes(torch, np, strategy, dense=None):
    """The dense merge of phase 3 on the card under the port's share
    scheduler, built from the port's config as the shard builds it
    (dbeel_tpu/server/shard.py:243-248): once with no foreground
    traffic, once with a request every 10 ms.  ``dense`` is phase 3's
    unthrottled result (n, sha, launches); without it (``--only
    planes``) the phase merges the keyspace unthrottled itself, held
    against the cpu merge, outside the main path's counts."""
    from dbeel_tpu_torch import config
    from dbeel_tpu_torch.ops import bitonic as B
    from dbeel_tpu_torch.server.scheduler import ShareScheduler
    from dbeel_tpu_torch.storage.compaction import get_strategy

    t_phase = time.perf_counter()
    cfg = config.parse_args([])
    shares = (cfg.foreground_tasks_shares, cfg.background_tasks_shares)
    if shares != (1000, 250):
        raise AssertionError(f"config shares {shares}, want (1000, 250)")
    scheduler = ShareScheduler(*shares)
    d = os.path.join(WORK, "planes")
    os.makedirs(d)
    idx = build_dense_runs(np, d, 1 << 18, 4)
    if dense is None:
        B.reset_launches()
        _, n, sha, _ = _merge(strategy, d, idx, 101)
        dense = dict(n=n, sha=sha, launches=dict(B.launches))
        _, n_cpu, sha_cpu, _ = _merge(get_strategy("cpu"), d, idx, 103)
        if (n, sha) != (n_cpu, sha_cpu):
            raise AssertionError("dense merge differs from the cpu merge")
    runs, walls = {}, {}
    for name, busy in (("planes_idle", False), ("planes_busy", True)):
        before = scheduler.stats()
        stop = threading.Event()
        marks = threading.Thread(target=_fg_marks, args=(scheduler, stop))
        if busy:
            marks.start()
        try:
            ((n, _, merge_s), wall), counts = _main_path_run(
                lambda: asyncio.run(
                    _throttled_unit(scheduler, strategy, d, idx, 109)
                )
            )
        finally:
            stop.set()
            if busy:
                marks.join(timeout=10)
        if marks.is_alive():
            raise AssertionError("the foreground thread did not stop")
        after = scheduler.stats()
        sha = _output_digest(d, 109)
        delta = {k: round(after[k] - before[k], 6) for k in (
            "foreground_ops", "background_busy_s",
            "background_throttled_s", "background_precharged_s")}
        walls[name] = wall
        runs[name] = counts
        log(f"planes {name}: unit {wall:.3f}s (merge {merge_s:.3f}s), "
            f"launches {counts}, sha256 equal to phase 3's dense merge: "
            f"{(n, sha) == (dense['n'], dense['sha'])}, this run's "
            f"scheduler {json.dumps(delta, sort_keys=True)}; stats() "
            f"{json.dumps(after, sort_keys=True)}")
        if (n, sha) != (dense["n"], dense["sha"]):
            raise AssertionError(f"{name} output differs from the dense merge")
        if counts != dense["launches"] or not (counts["K1"] and counts["K2"]):
            raise AssertionError(
                f"{name} launches {counts}, want {dense['launches']}"
            )
        if delta["background_precharged_s"] <= 0:
            raise AssertionError(f"{name}: the merge never ticked")
        if busy and delta["background_throttled_s"] <= 0:
            raise AssertionError("busy run: the merge was not throttled")
        if not busy and delta["background_throttled_s"] != 0:
            raise AssertionError("idle run: throttled with no foreground")
    ratio = walls["planes_busy"] / walls["planes_idle"]
    log(f"planes: busy/idle unit {ratio:.3f} "
        f"(1 + fg/bg = {1 + shares[0] / shares[1]:g})")
    shutil.rmtree(d)
    log(f"planes: {time.perf_counter() - t_phase:.1f}s")
    return runs


# ----------------------------------------------------------------------
# Phase 11: the serving planes
# ----------------------------------------------------------------------

# The data plane's gets of keys that were never written (answered from
# the tables' blooms and prefix index with no read), the fan-out's
# quorum writes (2 acks of 2 replicas), and the migration target's
# capacity: the smallest memtable whose flush sorts on the card
# (ops.sort.DEVICE_THRESHOLD) — the default 8192 sorts on the host.
SERVING_ABSENT = 10_000
SERVING_FANOUT_OPS = 10_000
SERVING_FANOUT_WINDOW = 512
MIGRATE_CAPACITY = 1 << 16


def _shard(d, device, cache_pages=8):
    """One MyShard as the server builds it, on the server's defaults
    (config.parse_args with only --dir), merging on ``device``."""
    from dbeel_tpu_torch import config
    from dbeel_tpu_torch.cluster.local_comm import LocalShardConnection
    from dbeel_tpu_torch.server.shard import MyShard, Shard
    from dbeel_tpu_torch.storage.page_cache import PageCache

    cfg = config.parse_args(["--dir", d])
    conn = LocalShardConnection(0)
    ring = [Shard(cfg.name, f"{cfg.name}-0", conn)]
    return MyShard(cfg, 0, ring, PageCache(cache_pages), conn,
                   device=device)


async def _close_shard(shard):
    """Cancel and await every task the shard owns, then close it."""
    tasks = list(shard._background_tasks)
    for t in tasks:
        t.cancel()
    await asyncio.gather(*tasks, return_exceptions=True)
    shard.close()


async def _scan_plane_stream(plane, request):
    """scan, then scan_next until the cursor is nil, retrying a shed
    chunk with its cursor as a client does.  Returns the decoded chunks
    and the sheds retried."""
    from dbeel_tpu_torch.errors import Overloaded
    from dbeel_tpu_torch.utils import msgpack_codec as codec

    chunks, rtype, sheds = [], "scan", 0
    while True:
        try:
            payload = await plane.handle(request, rtype)
        except Overloaded:
            sheds += 1
            if sheds > 100:
                raise
            await asyncio.sleep(0.05)
            continue
        chunk = codec.unpackb(payload)
        chunks.append(chunk)
        if chunk["cursor"] is None:
            return chunks, sheds
        request, rtype = {"cursor": chunk["cursor"]}, "scan_next"


async def _scan_plane_run(tree, live, n, device):
    """The coordinator side of a filtered scan over phase 6's tree: a
    comparison leaf and a range leaf through ScanPlane.handle("scan")
    with the default scan_bytes_per_slice, chunk by chunk, then a
    filtered count aggregate; a MyShard on the server's defaults holds
    the tree as its collection "c" and its handle_shard_request
    answers the SCAN pages.  Returns the launch counts."""
    from dbeel_tpu_torch import query as Q
    from dbeel_tpu_torch.ops import _cuda
    from dbeel_tpu_torch.server.shard import Collection
    from dbeel_tpu_torch.utils import msgpack_codec as codec

    shard = _shard(os.path.join(WORK, "scan", "shard"), device)
    # Phase 6's tree becomes the shard's collection as it stands:
    # reopening it through create_collection would rebuild its scan
    # stage, seconds of host time at this size.
    shard.collections["c"] = Collection(tree, 1)
    eval_paths = {}
    page = tree.scan_filter_page

    async def counted_page(*args):
        out = await page(*args)
        eval_paths[out[6]] = eval_paths.get(out[6], 0) + 1
        return out

    tree.scan_filter_page = counted_page
    lo, hi, cut = n // 5, n // 5 + n // 20, n // 5 + n // 40
    where = ["and", ["cmp", "v", "<", cut], ["range", "v", lo, hi]]
    want = [(k, val) for k, (val, _ts, v) in sorted(live.items())
            if lo <= v < cut]
    spec = Q.pack_spec(*Q.build_spec(where, None))
    count_spec = Q.pack_spec(*Q.build_spec(where, {"op": "count"}))
    try:
        _cuda.reset_launches()
        t0 = time.perf_counter()
        chunks, sheds = await _scan_plane_stream(
            shard.scan_plane, {"collection": "c", "spec": spec})
        t_scan = time.perf_counter() - t0
        pages = dict(eval_paths)
        t0 = time.perf_counter()
        counted, sheds2 = await _scan_plane_stream(
            shard.scan_plane, {"collection": "c", "spec": count_spec})
        t_count = time.perf_counter() - t0
        counts = dict(_cuda.launches)
    finally:
        del tree.scan_filter_page
    got = [(codec.packb(k), codec.packb(d)) for c in chunks
           for k, d in c["entries"]]
    stats = shard.scan_plane.stats()
    n_count = counted[-1].get("agg")
    log(f"scan_plane: {len(chunks)} chunks ({stats['bytes_per_slice']} B a "
        f"slice) in {t_scan:.2f}s, {len(got)} rows of {len(want)} "
        f"({len(got) / t_scan:.0f} rows/s), eval paths of the spec pages "
        f"{pages}, sheds retried {sheds + sheds2}; count aggregate "
        f"{n_count} in {t_count:.2f}s; launches {counts}; filter "
        f"{json.dumps(stats['filter'], sort_keys=True)}; paced "
        f"{stats['paced']} ({stats['paced_s']}s)")
    if got != want or n_count != len(want):
        raise AssertionError(f"scan_plane: {len(got)} rows (want "
                             f"{len(want)}), count {n_count}")
    if (stats["filter"]["device_evals"] < 1
            or set(pages) - {"device", "cached"}
            or stats["filter"]["device_evals"] != pages.get("device")):
        raise AssertionError(f"scan_plane: eval paths {pages}, device_evals "
                             f"{stats['filter']['device_evals']}")
    if shard.scan_plane.active_scans or shard._background_tasks - {
            shard.governor._hb_task}:
        raise AssertionError("scan_plane: work left behind")
    # The tree stays phase 6's to close.
    shard.collections.clear()
    await _close_shard(shard)
    return counts


def check_scan_plane_launches(runs):
    """The scan plane's filtered scan evaluates its two leaves on K8a and
    K8b, and nothing else."""
    got = runs["scan_plane"]
    rest = {k: v for k, v in got.items() if k not in ("K8a", "K8b")}
    if not got.get("K8a") or not got.get("K8b") or any(rest.values()):
        raise AssertionError(f"scan_plane launches {got}")


def _rwf_nowait(d) -> str:
    """None where preadv2(RWF_NOWAIT) serves a cached page in ``d`` (the
    C plane's table probes need it), else why not."""
    if not hasattr(os, "RWF_NOWAIT"):
        return "os.RWF_NOWAIT missing"
    p = os.path.join(d, "nowait-probe")
    with open(p, "wb") as f:
        f.write(b"x" * 4096)
    fd = os.open(p, os.O_RDONLY)
    try:
        os.preadv(fd, [bytearray(16)], 0, os.RWF_NOWAIT)
        return None
    except OSError as e:
        return (f"preadv2(RWF_NOWAIT) refused on kernel "
                f"{os.uname().release}: {e}")
    finally:
        os.close(fd)
        os.unlink(p)


async def _loop_settled(busy, tree, quiet_s=0.2):
    """Wait until the compaction loop has merged after the last flush:
    no compact_tree in flight and the tables unchanged for
    ``quiet_s``."""
    last, since = None, time.perf_counter()
    while True:
        now = tree.sstable_indices_and_sizes()
        if busy[0] or now != last:
            last, since = now, time.perf_counter()
        elif time.perf_counter() - since >= quiet_s:
            return
        await asyncio.sleep(0.01)


async def _serving_dp(torch, np, n_ops, device):
    """Returns (the shard, the oracle, the launches of the compaction
    loop's run and of the major compaction, writes/s)."""
    from dbeel_tpu_torch.ops import _cuda
    from dbeel_tpu_torch.server import coalescer, tasks
    from dbeel_tpu_torch.storage import LSMTree
    from dbeel_tpu_torch.storage.compaction import get_strategy
    from dbeel_tpu_torch.storage.entry import file_name
    from dbeel_tpu_torch.utils import msgpack_codec as codec

    # The arena phase's ops with each key as a client sends one: a
    # 16-character string (the hex of its first 8 bytes).  A binary key
    # whose encoding ends in NUL would make the scan stage decline the
    # tree, and migration would page it entry by entry.
    ops = [(k.hex()[:16], v) for k, v in
           shard_ops(np, 0, n_ops, overwrites=0.01, deletes=0.005)]
    t0 = time.perf_counter()
    frames = [codec.packb(
        {"type": "set", "collection": "c", "key": k, "value": v}
        if v is not None else {"type": "delete", "collection": "c", "key": k}
    ) for k, v in ops]
    oracle = dict(ops)
    log(f"serving_dp: {len(frames)} frames packed in "
        f"{time.perf_counter() - t0:.1f}s")
    # One shard on the server's defaults, with the arena phase's page
    # cache: its own data plane (armed by MyShard.__init__ with the
    # native overload frames) takes the frames, and its compaction loop
    # merges on the card while they are written.
    shard = _shard(os.path.join(WORK, "serving", "shard"), device,
                   cache_pages=16384)
    await shard.create_collection("c", 1)
    tree = shard.collections["c"].tree
    d = tree.dir_path
    capacity = tree.capacity
    dp = shard.dataplane
    if dp is None or tree.memtable_kind != "arena":
        raise AssertionError(f"serving_dp: data plane {dp}, memtable "
                             f"{tree.memtable_kind}")
    if tree.write_state_listener is None:
        raise AssertionError("serving_dp: the tree has no listener")
    busy = [0]
    real_compact_tree = tasks.compact_tree

    async def watched(*args):
        busy[0] += 1
        try:
            await real_compact_tree(*args)
        finally:
            busy[0] -= 1

    tasks.compact_tree = watched
    flushes, punts = [], 0
    units0 = shard.scheduler.stats()["background_units"]
    # Run serving_loop: the frames' writes with the shard's compaction
    # loop beside them, until the loop has merged after the last flush.
    _cuda.reset_launches()
    t0 = time.perf_counter()
    loop = shard.spawn(tasks.run_compaction_loop(shard))
    try:
        for i, frame in enumerate(frames):
            got = dp.try_handle(frame)
            if got is None:
                # The interpreted handler's write (db_server's set/delete).
                punts += 1
                key, value = ops[i]
                if value is None:
                    await tree.delete(codec.packb(key))
                else:
                    await tree.set(codec.packb(key), codec.packb(value))
            elif got[2] is not None:
                flushes.append(asyncio.ensure_future(got[2].flush()))
                await asyncio.sleep(0)
            elif i % 256 == 255:
                await asyncio.sleep(0)
        await asyncio.gather(*flushes)
        await tree.flush()
        t_write = time.perf_counter() - t0
        await _loop_settled(busy, tree)
        t_loop = time.perf_counter() - t0
        loop_counts = dict(_cuda.launches)
    finally:
        tasks.compact_tree = real_compact_tree
        loop.cancel()
        await asyncio.gather(loop, return_exceptions=True)
    stats = dp.stats()
    units = shard.scheduler.stats()["background_units"] - units0
    tables = [i for i, _ in tree.sstable_indices_and_sizes()]
    n_flushed = tree._index // 2
    log(f"serving_dp write: {n_ops} frames in {t_write:.2f}s "
        f"({n_ops / t_write:.0f} writes/s through try_handle, the "
        f"compaction loop beside them), {stats['fast_sets']} native sets, "
        f"{punts} punts, {len(flushes)} flushes asked for, {n_flushed} "
        f"tables of {capacity} entries flushed; the loop settled "
        f"{t_loop - t_write:.2f}s after the last flush: {units} background "
        f"units, {len(tables)} tables left, launches {loop_counts}")
    if stats["fast_sets"] + punts != n_ops or punts * 10 > n_ops:
        raise AssertionError(f"serving_dp: {stats['fast_sets']} native "
                             f"sets and {punts} punts of {n_ops}")
    # The loop swallows a failed merge (it logs it, as dbeel_tpu's does):
    # its merges must show here, on the card.
    if (not (loop_counts.get("K3", 0) + loop_counts.get("K4", 0))
            or len(tables) >= n_flushed or units < 1):
        raise AssertionError(f"serving_loop: launches {loop_counts}, "
                             f"{len(tables)} tables of {n_flushed} "
                             f"flushed, {units} background units")

    # Run serving_dp: the major compaction on the card; a copy of the same
    # tables merged by the cpu strategy must be SHA-256-equal.
    twin_dir = os.path.join(WORK, "serving", "twin")
    os.makedirs(twin_dir)
    for f in os.listdir(d):
        if not f.endswith(".memtable"):
            shutil.copy(os.path.join(d, f), twin_dir)
    out = max(tables) + 1
    _cuda.reset_launches()
    t0 = time.perf_counter()
    await tree.compact(tables, out, keep_tombstones=False)
    counts = dict(_cuda.launches)
    t_compact = time.perf_counter() - t0
    # The twin keeps the shard's tombstone GC grace (the server's
    # default: hint_ttl, 3 h), so both merges keep every tombstone.
    twin = LSMTree.open_or_create(twin_dir, capacity=capacity,
                                  memtable_kind="sorted",
                                  strategy=get_strategy("cpu"),
                                  gc_grace_s=tree.gc_grace_s)
    await twin.compact(tables, out, keep_tombstones=False)
    twin.close()
    digests = [{ext: _table_digests(x).get(file_name(out, ext))
                for ext in ("data", "index", "bloom", "sums")}
               for x in (d, twin_dir)]
    log(f"serving_dp compact: {len(tables)} tables in {t_compact:.2f}s on "
        f"{tree.strategy.name}, launches {counts}; SHA-256 equal to the "
        f"cpu merge of a copy: {digests[0] == digests[1]}")
    if digests[0] != digests[1] or digests[0]["data"] is None:
        raise AssertionError(f"serving_dp: compacted tables differ: {digests}")
    shutil.rmtree(twin_dir)

    # The compacted table reaches the C registry through the listener
    # (the swap, then its warmed read index).
    for _ in range(3000):
        fp = dp._table_fps.get("c")
        if fp and len(fp) == 1 and (fp[0][1] or fp[0][2]):
            break
        await asyncio.sleep(0.01)
    else:
        raise AssertionError(f"serving_dp: registry {dp._table_fps}")
    nowait = _rwf_nowait(d)
    live = sum(v is not None for v in oracle.values())
    t0 = time.perf_counter()
    native = native_deleted = bad = 0
    for key, value in oracle.items():
        got = dp.try_handle(codec.packb(
            {"type": "get", "collection": "c", "key": key}))
        if got is not None:
            native += value is not None
            native_deleted += value is None
            resp = got[0]
            ok = (resp[-1] == 1 and resp[4:-1] == codec.packb(value)
                  if value is not None else resp[-1] == 0)
        else:
            found = await tree.get(codec.packb(key))
            ok = found == (None if value is None else codec.packb(value))
        bad += not ok
    t_gets = time.perf_counter() - t0
    rng = np.random.default_rng(11)
    absent = [rng.bytes(8).hex() for _ in range(SERVING_ABSENT)]
    absent = [k for k in absent if k not in oracle]
    t0 = time.perf_counter()
    native_absent = 0
    for key in absent:
        got = dp.try_handle(codec.packb(
            {"type": "get", "collection": "c", "key": key}))
        if got is not None:
            native_absent += 1
            bad += got[0][-1] != 0
        else:
            bad += await tree.get(codec.packb(key)) is not None
    t_absent = time.perf_counter() - t0
    stats = dp.stats()
    log(f"serving_dp gets: {len(oracle)} keys ({live} live) in "
        f"{t_gets:.2f}s ({len(oracle) / t_gets:.0f} gets/s), {native} "
        f"live keys served natively from the card's table, "
        f"{native_deleted} deleted ones answered natively"
        + ("" if nowait is None else f" ({nowait}: the C probe punts "
           "every read, the interpreted path serves it)")
        + f"; {len(absent)} absent keys in {t_absent:.3f}s "
        f"({len(absent) / t_absent:.0f} gets/s), {native_absent} answered "
        f"natively from the bloom and prefix index; mismatches {bad}; "
        f"stats {json.dumps(stats, sort_keys=True)}")
    if bad:
        raise AssertionError(f"serving_dp: {bad} gets disagree")
    if nowait is None and native + native_deleted != len(oracle):
        raise AssertionError(f"serving_dp: {native + native_deleted} of "
                             f"{len(oracle)} gets served natively")
    if nowait is not None and native:
        raise AssertionError(f"serving_dp: {native} native table reads "
                             f"where {nowait}")
    if native_absent * 10 < len(absent) * 9:
        raise AssertionError(f"serving_dp: {native_absent} of {len(absent)} "
                             "absent keys answered natively")
    shard_stats = shard.get_stats()
    log("serving_dp get_stats: "
        + json.dumps(shard_stats, sort_keys=True, default=str))
    strategy = shard_stats["collections"]["c"]["strategy"]
    # On the card: "device on cuda", and the coalescer of cuda.
    want = f"{tree.strategy.name} on {torch.device(device).type}"
    if (not strategy.startswith(want)
            or shard_stats["device_coalescer"] != coalescer.stats(device)):
        raise AssertionError(f"serving_dp: get_stats names {strategy!r}, "
                             f"coalescer {shard_stats['device_coalescer']}")
    dp.unregister("c")
    return shard, oracle, loop_counts, counts, n_ops / t_write


async def _serving_migrate(np, shard, oracle, device):
    """One quarter of the ring out of the shard's collection into a
    hash-memtable tree on the card; returns the launch counts and
    keys/s."""
    from dbeel_tpu_torch.cluster.local_comm import LocalShardConnection
    from dbeel_tpu_torch.ops import _cuda
    from dbeel_tpu_torch.server import migration
    from dbeel_tpu_torch.server.shard import (
        MigrationAction, RangeAndAction, Shard,
    )
    from dbeel_tpu_torch.storage import LSMTree
    from dbeel_tpu_torch.storage.compaction import get_strategy
    from dbeel_tpu_torch.utils import msgpack_codec as codec
    from dbeel_tpu_torch.utils.murmur import hash_bytes

    src = shard.collections["c"].tree
    d = os.path.join(WORK, "serving", "migrate")
    os.makedirs(d)
    target = LSMTree.open_or_create(
        os.path.join(d, "target"), capacity=MIGRATE_CAPACITY,
        memtable_kind="hash", device=device,
        strategy=get_strategy("device", device=device))

    class Target(LocalShardConnection):
        """The receiving shard's apply of each ShardEvent.set."""

        async def send_message(self, source_id, message):
            _ev, _set, _col, key, value, ts = message
            await target.set_with_timestamp(bytes(key), bytes(value),
                                            int(ts))

    conn = Target(1)
    shard.shards.append(Shard("n1", "n1-0", conn, hash=0x40000000))
    shard.sort_consistent_hash_ring()
    start, end = 0xC0000000, 0x00000000  # (start, end]: a wrapping quarter
    journals = []
    real_replace = os.replace

    def spy(a, b):
        if os.path.basename(str(b)).startswith("migration-"):
            with open(a) as f:
                journals.append(json.load(f))
        return real_replace(a, b)

    units0 = shard.scheduler.stats()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    os.replace = spy
    try:
        await migration.migrate_actions(
            shard, "c", src,
            [RangeAndAction(start, end, MigrationAction.SEND, conn)],
            plan_epoch=shard.membership_epoch)
    finally:
        os.replace = real_replace
    t_mig = time.perf_counter() - t0
    await target.flush()
    await _settle(skip=shard._background_tasks)
    tables = [i for i, _ in target.sstable_indices_and_sizes()]
    t1 = time.perf_counter()
    await target.compact(tables, max(tables) + 1, keep_tombstones=False)
    t_compact = time.perf_counter() - t1
    counts = dict(_cuda.launches)
    units = {k: round(v - units0[k], 6) if isinstance(v, float) else
             v - units0[k] for k, v in shard.scheduler.stats().items()
             if isinstance(v, (int, float))}
    want = {}
    for key, value in oracle.items():
        enc = codec.packb(key)
        if value is not None and migration._in_migration_range(
                hash_bytes(enc), start, end):
            want[enc] = (codec.packb(value), (await src.get_entry(enc))[1])
    got = {}
    sa = None
    while True:
        es, more = await target.scan_page(0, 0, sa, None, 65536, 16 << 20,
                                          True)
        for k, v, ts in es:
            got[bytes(k)] = (bytes(v), int(ts))
        if not more:
            break
        sa = es[-1][0]
    last = journals[-1] if journals else None
    log(f"serving_migrate: {shard.keys_migrated} keys "
        f"({shard.bytes_migrated} value bytes) of the quarter ({start:#x}, "
        f"{end:#x}] out of the shard's collection in {t_mig:.2f}s "
        f"({shard.keys_migrated / t_mig:.0f} keys/s) under bg_slice, "
        f"scheduler {json.dumps(units, sort_keys=True)}"
        f"; target: {len(tables)} tables, compaction {t_compact:.2f}s, "
        f"launches {counts}; {len(journals)} journal writes, the last "
        f"{json.dumps(last and last['arcs'])}; target equals the oracle: "
        f"{got == want}")
    target.close()
    if got != want or not want:
        raise AssertionError(f"serving_migrate: {len(got)} keys, want "
                             f"{len(want)}")
    if last is None or not all(a["done"] for a in last["arcs"]) or \
            os.path.exists(os.path.join(shard.config.dir,
                                        "migration-0-c.json")):
        raise AssertionError(f"serving_migrate: journal {last}")
    return counts, shard.keys_migrated / t_mig


async def _fake_replica(ack, received):
    async def conn(reader, writer):
        try:
            while True:
                hdr = await reader.readexactly(4)
                body = await reader.readexactly(
                    int.from_bytes(hdr, "little"))
                received.append(len(body))
                writer.write(len(ack).to_bytes(4, "little") + ack)
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            writer.close()

    return await asyncio.start_server(conn, "127.0.0.1", 0)


async def _serving_fanout(n_ops):
    from dbeel_tpu_torch import config
    from dbeel_tpu_torch.cluster import messages as msgs
    from dbeel_tpu_torch.cluster.native_fanout import create_quorum_fanout

    cfg = config.parse_args([])

    class Shard:
        config = cfg
        tasks = set()
        hints = []

        def spawn(self, coro):
            t = asyncio.ensure_future(coro)
            self.tasks.add(t)
            return t

        def _record_hint(self, name, request):
            self.hints.append(name)

    shard = Shard()
    qf = create_quorum_fanout(shard)
    if qf is None:
        raise AssertionError("serving_fanout: no fan-out engine")
    ack = msgs.pack_message(["response", msgs.ShardResponse.SET])
    received = [[], []]
    servers = [await _fake_replica(ack, r) for r in received]

    class Conn:
        def __init__(self, port):
            self.address = f"127.0.0.1:{port}"

    conns = [(f"node{i}", Conn(s.sockets[0].getsockname()[1]))
             for i, s in enumerate(servers)]
    frames = []
    for i in range(n_ops):
        req = msgs.pack_message(msgs.ShardRequest.set(
            "c", b"key-%08d" % i, b"v" * 64, 1_000 + i))
        frames.append(len(req).to_bytes(4, "little") + req)
    first = qf.try_submit(frames[0], conns, 2, ack, "set", lambda: None)
    for _ in range(500):
        if all(qf._lib.dbeel_qf_stream_alive(qf._handle, p) for p in (0, 1)):
            break
        await asyncio.sleep(0.01)
    results, fallbacks = [], 0
    t0 = time.perf_counter()
    for i in range(0, n_ops, SERVING_FANOUT_WINDOW):
        futs = []
        for f in frames[i: i + SERVING_FANOUT_WINDOW]:
            fut = qf.try_submit(f, conns, 2, ack, "set", lambda: None)
            if fut is None:
                fallbacks += 1
            else:
                futs.append(fut)
        results += await asyncio.wait_for(asyncio.gather(*futs), 30)
    secs = time.perf_counter() - t0
    stats = qf.stats()
    qf.close()
    for s in servers:
        s.close()
    for t in list(shard.tasks):
        t.cancel()
    ok = sum(r == [None, None] for r in results)
    log(f"serving_fanout: {n_ops} quorum sets (2 acks of 2 loopback "
        f"replicas, {SERVING_FANOUT_WINDOW} in flight) in {secs:.3f}s "
        f"({n_ops / secs:.0f} ops/s), first submit before the streams "
        f"{first}, fallbacks {fallbacks}, acks matched {ok}, hints "
        f"{len(shard.hints)}, replicas received "
        f"{[len(r) for r in received]} frames; the engine drives plain "
        f"non-blocking sockets from the loop's selector (no io_uring); "
        f"stats {stats}")
    if (first is not None or fallbacks or ok != n_ops or shard.hints
            or stats["fast_fanout_ops"] != n_ops):
        raise AssertionError("serving_fanout: not every op resolved")
    return n_ops / secs


def phase_serving(torch, np, n_ops=ARENA_OPS, n_fanout=SERVING_FANOUT_OPS,
                  device="cuda"):
    """The data plane, migration and the quorum fan-out on the server's
    defaults.  Returns the launch counts of its two runs."""

    async def drive():
        shard, oracle, loop_counts, dp_counts, dp_rate = await _serving_dp(
            torch, np, n_ops, device)
        try:
            mig_counts, mig_rate = await _serving_migrate(
                np, shard, oracle, device)
        finally:
            await _close_shard(shard)
        fan_rate = await _serving_fanout(n_fanout)
        return ({"serving_loop": loop_counts, "serving_dp": dp_counts,
                 "serving_migrate": mig_counts}, dp_rate, mig_rate, fan_rate)

    t0 = time.perf_counter()
    runs, dp_rate, mig_rate, fan_rate = asyncio.run(drive())
    shutil.rmtree(os.path.join(WORK, "serving"))
    log(f"serving: {time.perf_counter() - t0:.1f}s (data plane "
        f"{dp_rate:.0f} writes/s, migration {mig_rate:.0f} keys/s, fan-out "
        f"{fan_rate:.0f} ops/s)")
    return runs


def check_serving_launches(runs):
    """The shard's compaction loop merges on K3 or K4 (where prefixes
    tie); the data plane's tree compacts on K3 (K4 where prefixes tie);
    the migration target's flushes sort on K5 and its compaction takes
    K3 (K4 on ties)."""
    got = runs["serving_loop"]
    rest = {k: v for k, v in got.items() if k not in ("K3", "K4")}
    if not (got.get("K3", 0) + got.get("K4", 0)) or any(rest.values()):
        raise AssertionError(f"serving_loop launches {got}")
    for run, allowed in (("serving_dp", ("K3", "K4")),
                         ("serving_migrate", ("K3", "K4", "K5"))):
        got = runs[run]
        rest = {k: v for k, v in got.items() if k not in allowed}
        if not got.get("K3") or any(rest.values()):
            raise AssertionError(f"{run} launches {got}")
    if not runs["serving_migrate"].get("K5"):
        raise AssertionError(f"serving_migrate launches "
                             f"{runs['serving_migrate']}")


# ----------------------------------------------------------------------
# Phase 12: one node serving over TCP
# ----------------------------------------------------------------------

NODE_SHARDS = 4
# Depth cut in half (262144 keys) to keep the whole script near 900 s on
# a slow host, and the interpreted leg from 65536 to 8192 keys to make
# room for the clients' phase; widths unchanged.
NODE_OPS = 131072
NODE_ABSENT = 10_000
NODE_DELETES = 1024
NODE_INTERP_OPS = 8192
NODE_CONNS = 64
# Frames in flight on a connection: 16 connections a shard keep 128
# frames queued there, under the governor's soft limit (192).
NODE_WINDOW = 8
# {"v": a uint32, "p": 52 bytes} packs to a 64-byte value.
NODE_PAD = 52
OK_BYTES = b"\xa2OK\x02"  # packb("OK") + the Bytes type byte


def _node_ports():
    """The first of 16 ports, every one free for TCP and UDP: db ports
    from it, peer ports from it + 5, gossip on it + 10."""
    import socket

    for base in range(7000, 10000, 16):
        free = True
        for port in range(base, base + 16):
            for kind in (socket.SOCK_STREAM, socket.SOCK_DGRAM):
                with socket.socket(socket.AF_INET, kind) as sock:
                    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                    try:
                        sock.bind(("127.0.0.1", port))
                    except OSError:
                        free = False
            if not free:
                break
        if free:
            return base
    raise RuntimeError("node: no 16 free ports in 7000-9999")


def _refused(port) -> bool:
    import socket

    try:
        with socket.create_connection(("127.0.0.1", port), timeout=1):
            return False
    except OSError:
        return True


# The load: a child process (``chip_smoke.py --node-load plan``) that
# imports the stdlib and the port's msgpack codec, and nothing else.


async def _load_frames(codec, ports, ops, conns, window):
    """Every (shard, frame, expected) of ``ops`` over ``conns`` keepalive
    connections (an equal share a shard, ops dealt round-robin), each
    with ``window`` frames in flight.  ``expected`` is the response
    bytes (payload and type byte) or an error kind.  An ``Overloaded``
    answer is sent again after 50 ms, as a client retries it.  Returns
    (seconds, mismatches, first mismatches, retries)."""
    import collections
    import struct

    per_shard = conns // len(ports)
    lanes = [[] for _ in range(per_shard * len(ports))]
    dealt = [0] * len(ports)
    for shard, frame, expected in ops:
        lanes[shard * per_shard + dealt[shard] % per_shard].append(
            (frame, expected))
        dealt[shard] += 1
    bad, first_bad, retries = [0], [], [0]

    async def lane(i, items):
        if not items:
            return
        items = collections.deque(items)
        reader, writer = await asyncio.open_connection(
            "127.0.0.1", ports[i // per_shard])
        try:
            while items:
                chunk = [items.popleft()
                         for _ in range(min(window, len(items)))]
                writer.write(b"".join(f for f, _ in chunk))
                again = []
                for frame, expected in chunk:
                    (n,) = struct.unpack("<I", await reader.readexactly(4))
                    resp = await reader.readexactly(n)
                    if resp[-1] == 0 and codec.unpackb(
                            resp[:-1])[0] == "Overloaded":
                        again.append((frame, expected))
                        continue
                    if isinstance(expected, bytes):
                        ok = resp == expected
                    else:
                        ok = resp[-1] == 0 and codec.unpackb(
                            resp[:-1])[0] == expected
                    if not ok:
                        bad[0] += 1
                        if len(first_bad) < 3:
                            first_bad.append([repr(frame[2:60]),
                                              repr(resp[:80])])
                if again:
                    retries[0] += len(again)
                    await asyncio.sleep(0.05)
                    items.extendleft(reversed(again))
        finally:
            writer.close()
            await writer.wait_closed()

    t0 = time.perf_counter()
    await asyncio.gather(*(lane(i, items) for i, items in enumerate(lanes)))
    return time.perf_counter() - t0, bad[0], first_bad, retries[0]


async def _request(codec, port, req):
    """One request on its own connection: (type byte, decoded body)."""
    import struct

    body = codec.packb(req)
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        writer.write(struct.pack("<H", len(body)) + body)
        (n,) = struct.unpack("<I", await reader.readexactly(4))
        resp = await reader.readexactly(n)
    finally:
        writer.close()
        await writer.wait_closed()
    return resp[-1], codec.unpackb(resp[:-1])


async def _load_scan(codec, port, request):
    """scan, then scan_next until the cursor is nil, a shed chunk sent
    again with its cursor: the rows sorted by key, their digest, the
    count aggregate, chunks and sheds."""
    rows, rtype, chunks, sheds, agg = [], "scan", 0, 0, None
    req = dict(request)
    t0 = time.perf_counter()
    while True:
        kind, body = await _request(codec, port, {**req, "type": rtype})
        if kind == 0:
            if body[0] != "Overloaded" or sheds > 200:
                raise RuntimeError(f"scan: {body}")
            sheds += 1
            await asyncio.sleep(0.05)
            continue
        chunks += 1
        rows.extend(body["entries"])
        agg = body.get("agg", agg)
        if body["cursor"] is None:
            break
        req, rtype = {"cursor": body["cursor"]}, "scan_next"
    rows.sort(key=lambda r: r[0])
    return {"rows": len(rows), "agg": agg, "chunks": chunks, "sheds": sheds,
            "s": time.perf_counter() - t0,
            "digest": hashlib.sha256(codec.packb(rows)).hexdigest()}


async def _load_steps(codec, plan):
    ports = plan["ports"]
    out = {}
    for step in plan["steps"]:
        name, kind = step["name"], step["kind"]
        if kind == "frames":
            secs, bad, first_bad, retries = await _load_frames(
                codec, ports, step["ops"], plan["conns"], plan["window"])
            out[name] = {"n": len(step["ops"]), "s": secs, "bad": bad,
                         "first_bad": first_bad, "retries": retries}
        elif kind == "request":
            t, body = await _request(codec, ports[0], step["request"])
            out[name] = {"type": t, "body": body}
        elif kind == "scan":
            out[name] = await _load_scan(codec, ports[0], step["request"])
        elif kind == "stats":
            out[name] = [(await _request(codec, p, {"type": "get_stats"}))[1]
                         for p in ports]
    return out


def node_load_main(plan_path) -> int:
    """The node phase's load, in its own process: one JSON line of
    counts, seconds and what the node answered."""
    import importlib.util
    import pickle

    # The codec module alone, by its path: the package's __init__s
    # import numpy.
    spec = importlib.util.spec_from_file_location(
        "msgpack_codec",
        os.path.join(ROOT, "dbeel_tpu_torch", "utils", "msgpack_codec.py"))
    codec = sys.modules["msgpack_codec"] = importlib.util.module_from_spec(
        spec)
    spec.loader.exec_module(codec)
    with open(plan_path, "rb") as f:
        plan = pickle.load(f)
    out = asyncio.run(_load_steps(codec, plan))
    # What this process imported beyond the stdlib (it runs with -S:
    # no site hooks).
    out["imports"] = sorted({m.split(".")[0] for m in sys.modules}
                            - set(sys.stdlib_module_names) - {"__main__"})
    print(json.dumps(out, default=repr))
    return 0


async def _run_load(plan, path, flag, site_packages):
    """Write ``plan`` to ``path`` and run the load child ``flag`` on it,
    with -S (no site packages) unless ``site_packages``; returns what
    it printed."""
    import pickle

    with open(path, "wb") as f:
        pickle.dump(plan, f)
    site = [] if site_packages else ["-S"]
    proc = await asyncio.create_subprocess_exec(
        sys.executable, *site, os.path.abspath(__file__), flag, path,
        stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.PIPE)
    stdout, stderr = await proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"{flag[2:]} failed ({proc.returncode}): "
                           f"{stderr.decode()[-3000:]}")
    imported = stderr.decode().strip()
    if imported:
        log(f"{flag[2:]} stderr: {imported[-2000:]}")
    return json.loads(stdout.decode().strip().splitlines()[-1])


# The node itself, in this process, so the launch counters are its own.


async def _start_node(d, device):
    """The port's run_node on config.parse_args(["--dir", d, "--shards",
    "4", "--port", ..., "--remote-shard-port", ..., "--gossip-port",
    ...]), the defaults for the rest; returns (config, its shards as
    run_node built them, its task) once every db port accepts."""
    from dbeel_tpu_torch import config
    from dbeel_tpu_torch.server import run as node_run

    base = _node_ports()
    cfg = config.parse_args([
        "--dir", d, "--shards", str(NODE_SHARDS), "--port", str(base),
        "--remote-shard-port", str(base + 5), "--gossip-port",
        str(base + 10)])
    shards = []
    real = node_run.create_shard

    def capture(*args, **kw):
        shards.append(real(*args, **kw))
        return shards[-1]

    node_run.create_shard = capture
    task = asyncio.ensure_future(node_run.run_node(cfg, device=device))
    try:
        deadline = time.perf_counter() + 120
        while len(shards) < NODE_SHARDS or any(
                _refused(cfg.db_port(i)) for i in range(NODE_SHARDS)):
            if task.done():
                task.result()
                raise RuntimeError("node: run_node returned at start")
            if time.perf_counter() > deadline:
                raise RuntimeError("node: db ports never accepted")
            await asyncio.sleep(0.05)
    finally:
        node_run.create_shard = real
    return cfg, shards, task


async def _stop_node(cfg, shards, task):
    """Stop every shard; run_node returns within 10 s and every db and
    peer port then refuses connections.  Returns the seconds."""
    t0 = time.perf_counter()
    for s in shards:
        await s.stop()
    await asyncio.wait_for(task, 10)
    secs = time.perf_counter() - t0
    open_ports = [p for i in range(NODE_SHARDS)
                  for p in (cfg.db_port(i), cfg.remote_port(i))
                  if not _refused(p)]
    if open_ports:
        raise AssertionError(f"node: ports {open_ports} still accept")
    return secs


def _node_docs(np, seed, n_ops, n_absent):
    """``n_ops`` distinct 16-character keys with 64-byte documents
    {"v": a uint32, "p": 52 bytes}, and ``n_absent`` other keys."""
    rng = np.random.default_rng([seed, 12])
    want = n_ops + n_absent
    blob = rng.bytes(8 * (want + 64)).hex()
    keys = list(dict.fromkeys(
        blob[i:i + 16] for i in range(0, len(blob), 16)))[:want]
    vs = rng.integers(1 << 16, 1 << 32, size=n_ops)
    pads = rng.bytes(NODE_PAD * n_ops)
    docs = [{"v": int(vs[i]), "p": pads[i * NODE_PAD:(i + 1) * NODE_PAD]}
            for i in range(n_ops)]
    return keys[:n_ops], docs, keys[n_ops:]


def _owners(shards, keys):
    """The db shard (by id) that owns each key on the node's ring."""
    import bisect

    from dbeel_tpu_torch.utils import msgpack_codec as codec
    from dbeel_tpu_torch.utils.murmur import murmur3_32_batch

    ring = shards[0]._hash_sorted
    hashes = shards[0]._sorted_hashes
    ids = {s.shard_name: s.id for s in shards}
    out = []
    for h in murmur3_32_batch([codec.packb(k) for k in keys]).tolist():
        out.append(ids[ring[bisect.bisect_left(hashes, h) % len(ring)].name])
    return out


def _frames_plan(codec, shards, pairs, kind):
    """(shard, frame, expected) for each (key, doc) of ``pairs``: sets
    answer "OK"; gets the document, or KeyNotFound where it is None;
    deletes "OK"."""
    ops = []
    for shard, (key, doc) in zip(_owners(shards, [k for k, _ in pairs]),
                                 pairs):
        req = {"type": kind, "collection": "c", "key": key,
               "keepalive": True}
        if kind == "set":
            req["value"] = doc
            expected = OK_BYTES
        elif kind == "get":
            expected = ("KeyNotFound" if doc is None
                        else codec.packb(doc) + b"\x01")
        else:
            expected = OK_BYTES
        body = codec.packb(req)
        ops.append((shard, len(body).to_bytes(2, "little") + body, expected))
    return ops


def _scan_where():
    """phase 6's scan_plane filter over this phase's values: a
    comparison leaf and a range leaf, about 0.5% of the rows."""
    lo = 1 << 31
    hi = lo + (1 << 32) // 100
    return ["and", ["cmp", "v", "<", (lo + hi) // 2], ["range", "v", lo, hi]]


def _where_rows(oracle):
    """[key, doc] of the dict ``oracle`` that _scan_where() selects."""
    where = _scan_where()
    lo, cut = where[2][2], where[1][3]
    return [[k, d] for k, d in oracle.items() if lo <= d["v"] < cut]


async def _node_tables(busy, shards):
    """Wait until every shard's compaction loop has merged after the
    last flush (``busy``: merges in flight); returns each shard's
    (flushed, tables left)."""
    out = []
    for s in shards:
        tree = s.collections["c"].tree
        await _loop_settled(busy, tree)
        out.append((tree._index // 2,
                    len(tree.sstable_indices_and_sizes())))
    return out


def _major_twins(cfg, shards, device):
    """Each shard's tables (copied after the node stopped), major-
    compacted on the card and by the cpu strategy: SHA-256 of both, by
    shard, and the card's launches."""
    from dbeel_tpu_torch.ops import _cuda
    from dbeel_tpu_torch.storage import LSMTree
    from dbeel_tpu_torch.storage.compaction import get_strategy
    from dbeel_tpu_torch.storage.entry import file_name

    out = []
    _cuda.reset_launches()
    for s in shards:
        src = os.path.join(cfg.dir, f"c-{s.id}")
        digests = {}
        for name, strategy in (("card", get_strategy("device", device=device)),
                               ("cpu", get_strategy("cpu"))):
            d = os.path.join(WORK, "node", "twins", f"{s.id}-{name}")
            os.makedirs(d)
            for f in os.listdir(src):
                if not f.endswith(".memtable"):
                    shutil.copy(os.path.join(src, f), d)
            tree = LSMTree.open_or_create(
                d, capacity=8192, memtable_kind="sorted", strategy=strategy,
                gc_grace_s=cfg.gc_grace_s())
            tables = [i for i, _ in tree.sstable_indices_and_sizes()]
            out_index = max(tables) + 1
            asyncio.run(tree.compact(tables, out_index,
                                     keep_tombstones=False))
            tree.close()
            digests[name] = {ext: _table_digests(d).get(file_name(
                out_index, ext)) for ext in ("data", "index", "bloom", "sums")}
            shutil.rmtree(d)
        out.append((len(tables), digests["card"] == digests["cpu"]
                    and digests["card"]["data"] is not None))
    return out, dict(_cuda.launches)


async def _node_leg_dp(torch, np, seed, n_ops, device):
    """The data-plane leg on a fresh node; returns what it measured."""
    from dbeel_tpu_torch import query as Q
    from dbeel_tpu_torch.ops import _cuda
    from dbeel_tpu_torch.server import coalescer, tasks
    from dbeel_tpu_torch.storage import LSMTree
    from dbeel_tpu_torch.utils import msgpack_codec as codec

    t0 = time.perf_counter()
    cfg, shards, task = await _start_node(
        os.path.join(WORK, "node", "dp"), device)
    t_start = time.perf_counter() - t0
    keys, docs, absent = _node_docs(np, seed, n_ops, NODE_ABSENT)
    rng = np.random.default_rng([seed, 13])
    dead = [keys[i] for i in rng.choice(n_ops, NODE_DELETES, replace=False)]
    oracle = dict(zip(keys, docs))
    where = _scan_where()
    gone = set(dead)
    scanned = sorted(_where_rows(
        {k: d for k, d in oracle.items() if k not in gone}))
    scan_spec = Q.pack_spec(*Q.build_spec(where, None))
    count_spec = Q.pack_spec(*Q.build_spec(where, {"op": "count"}))
    plan = {"ports": [cfg.db_port(i) for i in range(NODE_SHARDS)],
            "conns": NODE_CONNS, "window": NODE_WINDOW, "steps": [
        {"name": "create", "kind": "request", "request": {
            "type": "create_collection", "name": "c",
            "replication_factor": 1}},
        {"name": "sets", "kind": "frames", "ops": _frames_plan(
            codec, shards, list(oracle.items()), "set")},
        {"name": "gets", "kind": "frames", "ops": _frames_plan(
            codec, shards, list(oracle.items()), "get")},
        {"name": "absent", "kind": "frames", "ops": _frames_plan(
            codec, shards, [(k, None) for k in absent], "get")},
        {"name": "deletes", "kind": "frames", "ops": _frames_plan(
            codec, shards, [(k, None) for k in dead], "delete")},
        {"name": "deleted", "kind": "frames", "ops": _frames_plan(
            codec, shards, [(k, None) for k in dead], "get")},
        {"name": "scan", "kind": "scan", "request": {
            "collection": "c", "spec": scan_spec}},
        {"name": "count", "kind": "scan", "request": {
            "collection": "c", "spec": count_spec}},
        {"name": "get_stats", "kind": "stats"},
    ]}
    busy = [0]
    real_compact_tree = tasks.compact_tree

    async def watched(*args):
        busy[0] += 1
        try:
            await real_compact_tree(*args)
        finally:
            busy[0] -= 1

    # The loops' merges, by tree.
    merges = {}
    real_compact = LSMTree.compact

    async def counted(tree, *args, **kw):
        out = await real_compact(tree, *args, **kw)
        merges[tree.dir_path] = merges.get(tree.dir_path, 0) + 1
        return out

    LSMTree.compact = counted

    tasks.compact_tree = watched
    try:
        # Run node_dp: every count zeroed just before the load, read
        # after the last get_stats.
        _cuda.reset_launches()
        t0 = time.perf_counter()
        with _device_trace(torch, device) as prof:
            got = await _run_load(plan, os.path.join(WORK, "node", "dp.plan"),
                                  "--node-load", site_packages=False)
            wall = time.perf_counter() - t0
        counts = dict(_cuda.launches)
        tables = await _node_tables(busy, shards)
    finally:
        tasks.compact_tree = real_compact_tree
        LSMTree.compact = real_compact
    dp_stats = {}
    for s in shards:
        for k, v in s.dataplane.stats().items():
            dp_stats[k] = dp_stats.get(k, 0) + v
    stats = got.pop("get_stats")
    t_stop = await _stop_node(cfg, shards, task)
    busy_ms = _device_busy(prof)[0] if prof is not None else None
    by_shard = [merges.get(s.collections["c"].tree.dir_path, 0)
                for s in shards]
    return dict(cfg=cfg, shards=shards, got=got, counts=counts,
                tables=tables, merges=by_shard, stats=stats,
                dp_stats=dp_stats, wall=wall, busy_ms=busy_ms,
                t_start=t_start, t_stop=t_stop, scanned=scanned,
                coalescer=coalescer.stats(device))


async def _node_leg_interp(np, seed, n_ops, device):
    """The interpreted leg: a fresh node with DBEEL_NO_DATAPLANE=1."""
    from dbeel_tpu_torch.ops import _cuda
    from dbeel_tpu_torch.utils import msgpack_codec as codec

    os.environ["DBEEL_NO_DATAPLANE"] = "1"
    try:
        cfg, shards, task = await _start_node(
            os.path.join(WORK, "node", "interp"), device)
    finally:
        del os.environ["DBEEL_NO_DATAPLANE"]
    if any(s.dataplane is not None for s in shards):
        raise AssertionError("node_interp: a shard kept its data plane")
    keys, docs, _ = _node_docs(np, seed + 1, n_ops, 0)
    pairs = list(zip(keys, docs))
    plan = {"ports": [cfg.db_port(i) for i in range(NODE_SHARDS)],
            "conns": NODE_CONNS, "window": NODE_WINDOW, "steps": [
        {"name": "create", "kind": "request", "request": {
            "type": "create_collection", "name": "c",
            "replication_factor": 1}},
        {"name": "sets", "kind": "frames",
         "ops": _frames_plan(codec, shards, pairs, "set")},
        {"name": "gets", "kind": "frames",
         "ops": _frames_plan(codec, shards, pairs, "get")},
    ]}
    _cuda.reset_launches()
    got = await _run_load(plan, os.path.join(WORK, "node", "interp.plan"),
                          "--node-load", site_packages=False)
    counts = dict(_cuda.launches)
    t_stop = await _stop_node(cfg, shards, task)
    return dict(got=got, counts=counts, t_stop=t_stop)


def _check_load(leg, got):
    for name, step in got.items():
        if step.get("bad"):
            raise AssertionError(f"{leg} {name}: {step['bad']} answers "
                                 f"differ, first {step['first_bad']}")
        if "type" in step and step["type"] == 0:
            raise AssertionError(f"{leg} {name}: {step['body']}")


def phase_node(torch, np, seed=7, n_ops=NODE_OPS, n_interp=NODE_INTERP_OPS,
               device="cuda"):
    """One 4-shard port node serving over TCP while its compaction loops
    merge on the card.  Returns the launch counts of its three runs."""
    from dbeel_tpu_torch.utils import msgpack_codec as codec

    t0 = time.perf_counter()
    os.makedirs(os.path.join(WORK, "node"))
    dp = asyncio.run(_node_leg_dp(torch, np, seed, n_ops, device))
    got = dp["got"]
    imports = got.pop("imports")
    _check_load("node_dp", got)
    if imports != ["msgpack_codec"]:
        raise AssertionError(f"node load imported {imports}")
    dev_type = torch.device(device).type
    log("node get_stats: " + json.dumps(dp["stats"], sort_keys=True,
                                        default=repr))
    for st in dp["stats"]:
        strategy = st["collections"]["c"]["strategy"]
        want = json.loads(json.dumps(dp["coalescer"], default=repr))
        if (not strategy.startswith(f"device on {dev_type}")
                or st["device_coalescer"] != want):
            raise AssertionError(f"node: get_stats names {strategy!r}, "
                                 f"coalescer {st['device_coalescer']}")
    scan, count = got["scan"], got["count"]
    want_digest = hashlib.sha256(codec.packb(dp["scanned"])).hexdigest()
    if (scan["rows"] != len(dp["scanned"]) or scan["digest"] != want_digest
            or count["agg"] != len(dp["scanned"])):
        raise AssertionError(f"node scan: {scan['rows']} rows (want "
                             f"{len(dp['scanned'])}), count {count['agg']}")
    for i, (flushed, left) in enumerate(dp["tables"]):
        if not left < flushed:
            raise AssertionError(f"node: shard {i} has {left} tables of "
                                 f"{flushed} flushed")
    twins, major = _major_twins(dp["cfg"], dp["shards"], device)
    if not all(same for _n, same in twins):
        raise AssertionError(f"node_major: tables differ from cpu: {twins}")
    interp = asyncio.run(_node_leg_interp(np, seed, n_interp, device))
    interp["got"].pop("imports")
    _check_load("node_interp", interp["got"])
    secs = time.perf_counter() - t0
    legs = {"dp": got, "interp": interp["got"]}
    rates = {leg: {name: round(step["n"] / step["s"]) for name, step in
                   g.items() if "n" in step} for leg, g in legs.items()}
    busy = (f"{dp['busy_ms']:.2f} ms of {dp['wall'] * 1e3:.1f} ms = "
            f"{dp['busy_ms'] / (dp['wall'] * 1e3):.5f}"
            if dp["busy_ms"] is not None else "not traced (cpu)")
    data_frames = sum(got[n]["n"] for n in ("sets", "gets", "absent",
                                            "deletes", "deleted"))
    # Answered in C: sets and deletes, memtable gets and table gets.
    punts = data_frames - sum(dp["dp_stats"].get(k, 0) for k in (
        "fast_sets", "fast_gets", "fast_table_gets"))
    log(f"node: {NODE_SHARDS} shards, {NODE_CONNS} keepalive connections "
        f"({NODE_WINDOW} frames in flight each), started in "
        f"{dp['t_start']:.2f}s; data-plane leg {dp['wall']:.2f}s: rates/s "
        f"{json.dumps(rates['dp'])}, retries "
        f"{ {n: s['retries'] for n, s in got.items() if 'retries' in s} }, "
        f"punts {punts} of {data_frames} data frames (data plane "
        f"{json.dumps(dp['dp_stats'], sort_keys=True)}); scan {scan['rows']} "
        f"rows in {scan['chunks']} chunks {scan['s']:.2f}s ({scan['sheds']} "
        f"sheds), count {count['agg']} {count['s']:.2f}s; merges by shard "
        f"{dp['merges']}, (flushed, tables left) by shard {dp['tables']}; "
        f"card busy {busy}; launches {dp['counts']}; stopped in "
        f"{dp['t_stop']:.2f}s")
    log(f"node_major: (tables, SHA-256-equal to the cpu merge) by shard "
        f"{twins}, launches {major}")
    log(f"node_interp (DBEEL_NO_DATAPLANE=1): rates/s "
        f"{json.dumps(rates['interp'])}, retries "
        f"{ {n: s['retries'] for n, s in interp['got'].items() if 'retries' in s} }, "
        f"launches {interp['counts']}; stopped in {interp['t_stop']:.2f}s")
    shutil.rmtree(os.path.join(WORK, "node"))
    log(f"node: {secs:.1f}s")
    return {"node_dp": dp["counts"], "node_major": major,
            "node_interp": interp["counts"]}


def check_node_launches(runs):
    """The node's compaction loops merge on K3 or K4 (where prefixes
    tie), its filtered scan evaluates on K8a and K8b, and nothing else
    launches; the major compactions take K3 (K4 on ties); the
    interpreted leg's loops launch K3 or K4 only."""
    got = runs["node_dp"]
    rest = {k: v for k, v in got.items()
            if k not in ("K3", "K4", "K8a", "K8b")}
    if not (got.get("K3", 0) + got.get("K4", 0)) or any(rest.values()):
        raise AssertionError(f"node_dp launches {got}")
    for run in ("node_major", "node_interp"):
        got = runs[run]
        rest = {k: v for k, v in got.items() if k not in ("K3", "K4")}
        if any(rest.values()) or (run == "node_major" and not got.get("K3")):
            raise AssertionError(f"{run} launches {got}")


# ----------------------------------------------------------------------
# Phase 13: the port's own clients driving one node
# ----------------------------------------------------------------------

# The C client at node_dp's width: 131072 sets and gets, 10000 absent
# keys, 1024 deletes; both clients batch 4096 keys in 64s.
CLIENT_OPS = 131072
CLIENT_ABSENT = 10_000
CLIENT_DELETES = 1024
CLIENT_MULTI = 4096
CLIENT_BATCH = 64
# Responses the C client's pipelined train leaves unread on a
# connection (one a shard): 64, as many as the async client keeps in
# flight a shard, under the governor's soft limit (192).
CLIENT_WINDOW = 64
# The async client: 32768 sets and gets with 256 in flight (a pipelined
# connection of 64 a shard), and a burst of 1024 sets under a watcher.
CLIENT_ASYNC_OPS = 32768
CLIENT_INFLIGHT = 256
CLIENT_WATCH = 1024


def _rows_digest(codec, rows):
    return hashlib.sha256(codec.packb(sorted(rows))).hexdigest()


def _load_native(np, codec, plan, out):
    """The C client's steps on collection "n"; a dict per step with its
    ops, seconds and answers that differ from the oracle."""
    from dbeel_tpu_torch import errors
    from dbeel_tpu_torch.client.native_client import NativeDbeelClient

    seed, port, n_ops = plan["seed"], plan["port"], plan["n_ops"]
    keys, docs, absent = _node_docs(np, seed + 2, n_ops + CLIENT_MULTI,
                                    CLIENT_ABSENT)
    mkeys, mdocs = keys[n_ops:], docs[n_ops:]
    keys, docs = keys[:n_ops], docs[:n_ops]
    oracle = dict(zip(keys, docs))
    rng = np.random.default_rng([seed, 14])
    dead = [keys[i] for i in rng.choice(n_ops, CLIENT_DELETES,
                                        replace=False)]

    with NativeDbeelClient("127.0.0.1", port) as cli:
        def overloaded():
            """The Overloaded answers the node has sent (sheds and
            expired deadlines, in C or interpreted), over its shards:
            the C walk retries each, a pipelined train counts each as
            a failure."""
            return sum(
                o["shed_ops"] + o["deadline_drops"]
                for o in (cli.get_stats("127.0.0.1", p)["overload"]
                          for p in plan["ports"]))

        def step(name, n, fn):
            before = overloaded()
            t0 = time.perf_counter()
            res = fn()
            s = time.perf_counter() - t0
            out[name] = {"n": n, "s": s, "retries": overloaded() - before,
                         **res}

        def create():
            cli.create_collection("n", 1)
            cli.sync_metadata()
            # Every shard holds the collection before the load starts.
            deadline = time.perf_counter() + 30
            while not all("n" in cli.get_stats("127.0.0.1", p)["collections"]
                          for p in plan["ports"]):
                if time.perf_counter() > deadline:
                    raise RuntimeError("client: collection n never reached "
                                       "every shard")
                time.sleep(0.05)
            return {"ring": cli.ring_size, "bad": 0}

        step("native_create", 1, create)

        def pipe_sets():
            # A set the train could not land (a shed too) is a wrong
            # answer: the train does not retry.
            failed = cli.pipe_run("n", "set", keys, docs,
                                  window=CLIENT_WINDOW)
            return {"failed": failed, "bad": failed}

        step("native_pipe_set", n_ops, pipe_sets)

        def pipe_gets():
            for k in keys:
                cli.pipe_get("n", k, window=CLIENT_WINDOW)
            failed = cli.pipe_drain()
            return {"failed": failed, "bad": failed}

        step("native_pipe_get", n_ops, pipe_gets)

        def verify():
            got = cli.multi_get("n", keys)
            return {"bad": sum(g != d for g, d in zip(got, docs))}

        step("native_verify", n_ops, verify)

        def absent_gets():
            bad = 0
            for k in absent:
                try:
                    cli.get("n", k)
                    bad += 1
                except errors.KeyNotFound:
                    pass
            return {"bad": bad}

        step("native_absent", CLIENT_ABSENT, absent_gets)

        def deletes():
            bad = 0
            for k in dead:
                cli.delete("n", k)
            for k in dead:
                try:
                    cli.get("n", k)
                    bad += 1
                except errors.KeyNotFound:
                    pass
            for k in dead:
                del oracle[k]
            return {"bad": bad}

        step("native_delete", 2 * CLIENT_DELETES, deletes)

        def multi():
            for i in range(0, CLIENT_MULTI, CLIENT_BATCH):
                cli.multi_set("n", list(zip(mkeys[i:i + CLIENT_BATCH],
                                            mdocs[i:i + CLIENT_BATCH])))
            bad = 0
            for i in range(0, CLIENT_MULTI, CLIENT_BATCH):
                got = cli.multi_get("n", mkeys[i:i + CLIENT_BATCH])
                bad += sum(g != d for g, d in
                           zip(got, mdocs[i:i + CLIENT_BATCH]))
            oracle.update(zip(mkeys, mdocs))
            return {"bad": bad}

        step("native_multi", 2 * CLIENT_MULTI, multi)
        want = _where_rows(oracle)

        def scan():
            rows = [[k, d] for k, d in cli.scan("n", filter=_scan_where())]
            return {"rows": len(rows), "bad": int(
                _rows_digest(codec, rows) != _rows_digest(codec, want))}

        step("native_scan", 1, scan)

        def count():
            n = cli.count("n", filter=_scan_where())
            return {"count": n, "bad": int(n != len(want))}

        step("native_count", 1, count)

        def cas():
            k = next(k for k in keys if k in oracle)
            new = {"v": 1, "p": b"cas"}
            lost = cli.cas("n", k, new, expect_value={"v": 0})
            won = cli.cas("n", k, new, expect_value=oracle[k])
            return {"bad": int(lost or not won or cli.get("n", k) != new)}

        step("native_cas", 2, cas)

        def stats():
            strategies = [
                cli.get_stats("127.0.0.1", p)["collections"]["n"]["strategy"]
                for p in plan["ports"]]
            return {"strategies": strategies, "bad": 0}

        step("native_stats", len(plan["ports"]), stats)
    return len(want)


async def _load_async(np, plan, out):
    """The async client's steps on collection "a"."""
    from dbeel_tpu_torch import errors
    from dbeel_tpu_torch.client import DbeelClient
    from dbeel_tpu_torch.utils import msgpack_codec as codec
    from dbeel_tpu_torch.utils.murmur import hash_bytes

    seed, n_ops = plan["seed"], plan["n_async"]
    keys, docs, _ = _node_docs(np, seed + 3,
                               n_ops + CLIENT_MULTI + CLIENT_WATCH, 0)
    akeys, adocs = keys[:n_ops], docs[:n_ops]
    mkeys = keys[n_ops:n_ops + CLIENT_MULTI]
    mdocs = docs[n_ops:n_ops + CLIENT_MULTI]
    wkeys, wdocs = keys[-CLIENT_WATCH:], docs[-CLIENT_WATCH:]
    oracle = {}
    client = await DbeelClient.from_seed_nodes(
        [("127.0.0.1", plan["port"])], pipeline_window=CLIENT_INFLIGHT // 4)
    # Count the Overloaded answers the walk retried, by step.
    sheds = [0]
    real_send = client._send_to

    async def counted(host, port, request):
        try:
            return await real_send(host, port, request)
        except errors.Overloaded:
            sheds[0] += 1
            raise

    client._send_to = counted

    async def step(name, n, coro_fn):
        before = sheds[0]
        t0 = time.perf_counter()
        res = await coro_fn()
        out[name] = {"n": n, "s": time.perf_counter() - t0,
                     "retries": sheds[0] - before, **res}

    async def fan(items, fn):
        """``fn(item)`` over ``items`` with CLIENT_INFLIGHT in flight."""
        results = {}

        async def worker():
            for i, item in it:
                results[i] = await fn(item)

        it = iter(enumerate(items))
        await asyncio.gather(*(worker() for _ in range(CLIENT_INFLIGHT)))
        return [results[i] for i in range(len(items))]

    try:
        col = None

        async def create():
            nonlocal col
            col = await client.create_collection("a", replication_factor=1)
            return {"bad": 0}

        await step("async_create", 1, create)

        async def sets():
            await fan(list(zip(akeys, adocs)), lambda kd: col.set(*kd))
            oracle.update(zip(akeys, adocs))
            return {"bad": 0}

        await step("async_set", n_ops, sets)

        async def gets():
            got = await fan(akeys, col.get)
            return {"bad": sum(g != d for g, d in zip(got, adocs))}

        await step("async_get", n_ops, gets)

        async def multi():
            for i in range(0, CLIENT_MULTI, CLIENT_BATCH):
                await col.multi_set(list(zip(mkeys[i:i + CLIENT_BATCH],
                                             mdocs[i:i + CLIENT_BATCH])))
            bad = 0
            for i in range(0, CLIENT_MULTI, CLIENT_BATCH):
                got = await col.multi_get(mkeys[i:i + CLIENT_BATCH])
                bad += sum(g != d for g, d in
                           zip(got, mdocs[i:i + CLIENT_BATCH]))
            oracle.update(zip(mkeys, mdocs))
            return {"bad": bad}

        await step("async_multi", 2 * CLIENT_MULTI, multi)
        want = _where_rows(oracle)

        async def scan():
            rows = [[k, d] async for k, d in col.scan(filter=_scan_where())]
            return {"rows": len(rows), "bad": int(
                _rows_digest(codec, rows) != _rows_digest(codec, want))}

        await step("async_scan", 1, scan)

        async def count():
            n = await col.count(filter=_scan_where())
            total = await col.count(filter=_scan_where(),
                                    aggregate={"op": "sum", "field": "v"})
            return {"count": n, "sum": total, "bad": int(
                n != len(want) or total != sum(d["v"] for _k, d in want))}

        await step("async_count", 2, count)

        async def atomic():
            k = akeys[0]
            new = {"v": 2, "p": b"cas"}
            bad = 0
            try:
                await col.cas(k, new, expect_value={"v": 0})
                bad += 1
            except errors.CasConflict:
                pass
            await col.cas(k, new, expect_value=oracle[k])
            bad += int(await col.get(k) != new)
            for _ in range(3):
                await col.rmw("rmw-counter", lambda v: (v or 0) + 1)
            bad += int(await col.get("rmw-counter") != 3)
            # Four keys on the arc of akeys[1]: one batch, one arc.
            def arc(k):
                return client._shards_for_key(
                    hash_bytes(codec.packb(k)), 1)[0].hash

            same = list(itertools.islice(
                (k for k in akeys[1:] if arc(k) == arc(akeys[1])), 4))
            await col.atomic_batch(
                [{"key": same[0], "value": {"v": 3}, "expect_value":
                  oracle[same[0]]}]
                + [{"key": k, "delete": True} for k in same[1:]])
            bad += int(await col.get(same[0]) != {"v": 3})
            for k in same[1:]:
                try:
                    await col.get(k)
                    bad += 1
                except errors.KeyNotFound:
                    pass
            return {"bad": bad}

        await step("async_atomic", 12, atomic)

        async def watch():
            w = col.watcher(wait_ms=100)
            await w.next_events()
            await fan(list(zip(wkeys, wdocs)), lambda kd: col.set(*kd))
            seen = []
            deadline = time.perf_counter() + 60
            while len(seen) < CLIENT_WATCH and time.perf_counter() < deadline:
                seen += [(k, v) for k, v, _ts, _fl in await w.next_events()]
            by_key = {}
            for k, v in seen:
                by_key.setdefault(k, []).append(v)
            want_w = dict(zip(wkeys, wdocs))
            bad = sum(by_key.get(k) != [d] for k, d in want_w.items())
            bad += sum(k not in want_w for k in by_key)
            return {"events": len(seen), "chunks": w.chunks,
                    "dup_flagged": w.dup_flagged,
                    "monotonicity_violations": w.monotonicity_violations,
                    "bad": bad + w.dup_flagged + w.monotonicity_violations}

        await step("async_watch", CLIENT_WATCH, watch)
    finally:
        client.close()
    return len(want)


def client_load_main(plan_path) -> int:
    """Phase 13's load, in its own process: the port's two clients, one
    JSON line of what they measured and of what this process imported."""
    import pickle

    import numpy as np

    with open(plan_path, "rb") as f:
        plan = pickle.load(f)

    from dbeel_tpu_torch.client import DbeelClientSync
    from dbeel_tpu_torch.utils import msgpack_codec as codec

    out = {}
    out["native_rows"] = _load_native(np, codec, plan, out)
    out["async_rows"] = asyncio.run(_load_async(np, plan, out))
    t0 = time.perf_counter()
    sync = DbeelClientSync([("127.0.0.1", plan["port"])])
    try:
        stats = sync.get_stats()
    finally:
        sync._client.close()
        sync.close()
    out["sync_stats"] = {"n": 1, "s": time.perf_counter() - t0,
                         "shard": stats["shard"],
                         "bad": int(sorted(stats["collections"]) != ["a", "n"])}
    import torch

    out["imports"] = sorted(
        m for m in sys.modules if m.split(".")[0] in (
            "jax", "jaxlib", "dbeel_tpu", "msgpack"))
    out["cuda_initialized"] = torch.cuda.is_initialized()
    print(json.dumps(out, default=repr))
    return 0


async def _client_leg(torch, seed, n_ops, n_async, device):
    from dbeel_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    cfg, shards, task = await _start_node(
        os.path.join(WORK, "client", "node"), device)
    t_start = time.perf_counter() - t0
    plan = {"seed": seed, "port": cfg.db_port(0), "n_ops": n_ops,
            "n_async": n_async,
            "ports": [cfg.db_port(i) for i in range(NODE_SHARDS)]}
    # Run node_client: every count zeroed just before the load, read
    # after its last answer.
    _cuda.reset_launches()
    t0 = time.perf_counter()
    with _device_trace(torch, device) as prof:
        got = await _run_load(
            plan, os.path.join(WORK, "client", "plan"), "--client-load",
            site_packages=True)
        wall = time.perf_counter() - t0
    counts = dict(_cuda.launches)
    tables = [len(s.collections["n"].tree.sstable_indices_and_sizes())
              for s in shards]
    t_stop = await _stop_node(cfg, shards, task)
    busy_ms = _device_busy(prof)[0] if prof is not None else None
    return dict(got=got, counts=counts, wall=wall, busy_ms=busy_ms,
                t_start=t_start, t_stop=t_stop, tables=tables)


def phase_client(torch, seed=7, n_ops=CLIENT_OPS, n_async=CLIENT_ASYNC_OPS,
                 device="cuda"):
    """A 4-shard port node driven by the port's own clients from a child
    process: ``n_ops`` keys through the C client, ``n_async`` through the
    async one.  Returns the launch counts of the run."""
    t0 = time.perf_counter()
    os.makedirs(os.path.join(WORK, "client"))
    leg = asyncio.run(_client_leg(torch, seed, n_ops, n_async, device))
    got = leg["got"]
    imported = got.pop("imports")
    if imported:
        raise AssertionError(f"client load imported {imported}")
    if got.pop("cuda_initialized"):
        raise AssertionError("client load initialised CUDA")
    native_rows, async_rows = got.pop("native_rows"), got.pop("async_rows")
    bad = {name: step["bad"] for name, step in got.items() if step["bad"]}
    if bad:
        raise AssertionError(f"client: answers differ from the oracle: "
                             f"{bad}; {json.dumps(got, default=repr)[:3000]}")
    dev_type = torch.device(device).type
    strategies = got["native_stats"]["strategies"]
    if not all(s.startswith(f"device on {dev_type}") for s in strategies):
        raise AssertionError(f"client: get_stats names {strategies}")
    secs = time.perf_counter() - t0
    rates = {name: round(step["n"] / step["s"]) for name, step in got.items()
             if step["s"] > 0}
    retries = {name: step["retries"] for name, step in got.items()
               if "retries" in step}
    busy = (f"{leg['busy_ms']:.2f} ms of {leg['wall'] * 1e3:.1f} ms = "
            f"{leg['busy_ms'] / (leg['wall'] * 1e3):.5f}"
            if leg["busy_ms"] is not None else "not traced (cpu)")
    log(f"client: {NODE_SHARDS}-shard node started in {leg['t_start']:.2f}s; "
        f"load {leg['wall']:.2f}s (one child: NativeDbeelClient on n, "
        f"DbeelClient with {CLIENT_INFLIGHT} in flight on a); rates/s "
        f"{json.dumps(rates)}; seconds "
        f"{ {n: round(s['s'], 3) for n, s in got.items()} }; retries after "
        f"Overloaded (C: the node's answers in the step) {retries}; "
        f"pipe_set failed "
        f"{got['native_pipe_set']['failed']}; scans {native_rows} rows (C) "
        f"and {async_rows} rows (async) equal to the oracle; watch "
        f"{got['async_watch']['events']} events in "
        f"{got['async_watch']['chunks']} chunks; tables by shard "
        f"{leg['tables']}; strategies {strategies}; card busy {busy}; "
        f"launches {leg['counts']}; stopped in {leg['t_stop']:.2f}s")
    shutil.rmtree(os.path.join(WORK, "client"))
    log(f"client: {secs:.1f}s")
    return {"node_client": leg["counts"]}


def check_client_launches(runs):
    """The node's compaction loops merge on K3 or K4 (where prefixes
    tie), the clients' filtered scans and counts evaluate on K8a and
    K8b, and nothing else launches."""
    got = runs["node_client"]
    rest = {k: v for k, v in got.items()
            if k not in ("K3", "K4", "K8a", "K8b")}
    if (not (got.get("K3", 0) + got.get("K4", 0)) or not got.get("K8a")
            or not got.get("K8b") or any(rest.values())):
        raise AssertionError(f"node_client launches {got}")


# ----------------------------------------------------------------------


PHASES = ("kernels", "compaction", "lsm", "shards", "scan", "mesh", "arena",
          "index", "planes", "serving", "node", "client")


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--only", default=",".join(PHASES),
        help="comma-separated phases to run after phase 1 "
             f"(default: all of {','.join(PHASES)}; planes without "
             "compaction merges the dense keyspace unthrottled itself)",
    )
    parser.add_argument(
        "--seed", type=int, default=7,
        help="seed of the node and client phases' keys and documents "
             "(default 7)",
    )
    parser.add_argument("--node-load", help=argparse.SUPPRESS)
    parser.add_argument("--client-load", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.node_load:
        return node_load_main(args.node_load)
    if args.client_load:
        sys.path.insert(0, ROOT)
        return client_load_main(args.client_load)
    only = [p for p in args.only.split(",") if p]
    if not set(only) <= set(PHASES):
        parser.error(f"unknown phase in {args.only!r}")
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "dbeel_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    t_start = time.perf_counter()
    kernels, runs = [], {}
    try:
        card = phase_facts(torch)
        if "kernels" in only:
            kernels = phase_kernels(torch, np)
        from dbeel_tpu_torch.storage.compaction import get_strategy

        # auto: the one-card device strategy, or the mesh over every
        # card; phases 3-6 hold their routes on the device strategy.
        auto = get_strategy("auto")
        want = "distributed" if torch.cuda.device_count() > 1 else "device"
        if auto.name != want or auto.device.type != "cuda":
            raise AssertionError(
                f"auto resolved to {auto.name} on {auto.device}, want {want}"
            )
        strategy = get_strategy("device")
        bench = None
        if "compaction" in only:
            phase_runs, bench = phase_compaction(
                torch, np, card, BENCH_KEYS, strategy
            )
            runs.update(phase_runs)
        if "lsm" in only:
            runs.update(phase_lsm(np, LSM_OPS, strategy))
        if "shards" in only:
            shard_runs = phase_shards(torch, np)
            check_shard_launches(shard_runs)
            runs.update(shard_runs)
        if "scan" in only:
            scan_runs = phase_scan(torch, np, strategy=strategy)
            check_scan_launches(scan_runs)
            check_scan_plane_launches(scan_runs)
            runs.update(scan_runs)
            from dbeel_tpu_torch.ops import query_kernels

            with open(query_kernels.last_good_path()) as f:
                log(f"DEVICE_LAST_GOOD ({query_kernels.last_good_path()}): "
                    f"{json.dumps(json.load(f), sort_keys=True)}")
        if "mesh" in only:
            mesh_runs = phase_mesh(torch, np, bench)
            check_mesh_launches(mesh_runs)
            runs.update(mesh_runs)
        elif bench is not None:
            shutil.rmtree(bench["dir"])
        if "arena" in only:
            arena_runs = phase_arena(torch, np)
            check_arena_launches(arena_runs)
            runs.update(arena_runs)
        if "index" in only:
            index_runs = phase_index(torch, np, strategy=strategy)
            check_index_launches(index_runs)
            runs.update(index_runs)
        if "planes" in only:
            runs.update(phase_planes(
                torch, np, strategy, bench["dense"] if bench else None
            ))
        if "serving" in only:
            serving_runs = phase_serving(torch, np)
            check_serving_launches(serving_runs)
            runs.update(serving_runs)
        if "node" in only:
            node_runs = phase_node(torch, np, seed=args.seed)
            check_node_launches(node_runs)
            runs.update(node_runs)
        if "client" in only:
            client_runs = phase_client(torch, seed=args.seed)
            check_client_launches(client_runs)
            runs.update(client_runs)
        log(f"launches by run: {json.dumps(runs, sort_keys=True)}")
        for row in kernels:
            # A kernel folded into another's launch has no counter.
            by_run = {run: c.get(row["name"], 0) for run, c in runs.items()}
            row["launches"] = sum(by_run.values())
            row["launches_by_run"] = by_run
        log(f"total {time.perf_counter() - t_start:.1f}s")
    except Exception:
        import traceback

        traceback.print_exc()
        return 1
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
