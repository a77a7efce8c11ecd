"""Hash-range migration executor.

Role parity with reference src/tasks/migration.rs:19-169: given a
collection tree and (start, end] ring ranges with actions, stream every
matching entry as a Set event over one persistent TCP stream (remote) or
the local packet channel, or tombstone-delete the range.

Elastic-membership upgrades over the reference:

- **Arc-sequential, key-ordered streaming** via the scan plane's
  ``scan_page`` (ordered, newest-wins, hash-range filtered) instead of
  one unordered full-tree pass — which is what makes the per-arc
  cursor below SOUND: everything at/below the cursor has provably been
  dispatched.
- **Resumable**: progress journals to
  ``{dir}/migration-{shard}-{collection}.json`` (per-arc cursor + done
  flag, atomic replace per page).  ``resume_migrations`` picks the
  journals up at shard start and restreams only the unfinished tail.
- **Epoch-fenced**: the spawning plan carries the membership epoch; a
  newer membership change (epoch bump) aborts between pages — the
  replacement plan computed from the CURRENT ring owns the arcs now.
- **Governor-paced**: every page runs under a ``bg_slice`` (as before)
  and ``--migration-keys-per-sec`` adds an explicit open-loop ceiling
  so bulk handoff cannot starve foreground tails (the LSM
  background-interference result from the compaction survey applies
  verbatim to migration I/O).
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
from typing import List, Optional

from ..cluster.local_comm import LocalShardConnection
from ..cluster.messages import ShardEvent
from ..cluster.remote_comm import RemoteShardConnection
from ..flow_events import FlowEvent
from ..storage.lsm_tree import LSMTree

log = logging.getLogger(__name__)

MIGRATION_BATCH_ENTRIES = 128  # one share-scheduler unit
MIGRATION_BATCH_BYTES = 1 << 20  # per-page byte ceiling

# DBEEL_MIGRATION_DELETE=1 makes migration DELETE actions tombstone
# the evacuated range (the reference behavior).  Default OFF: the
# tombstones get CURRENT timestamps, so when ownership of the range
# later REVERTS — add a node, evacuate arcs to it, then that node
# dies or scales back in — the old owner's tombstones are newer than
# the acked values the surviving replicas still hold, and one
# anti-entropy cycle propagates the deletes cluster-wide.  Long
# theorized; the membership-churn soak gate (chaos_soak.py --churn)
# OBSERVED it: every journal key untouched across an
# add/remove cycle read back KeyNotFound on ALL replicas.  Off,
# evacuated data stays until overwritten (space-only cost, same
# stance resume_migrations already takes for crashed DELETE arcs);
# stale copies that resurface on ownership reversion lose to any
# newer replica under LWW, so correctness never depended on the
# deletes.  Operators on monotone scale-out topologies can opt back
# in for the space.
_MIGRATION_DELETE = os.environ.get(
    "DBEEL_MIGRATION_DELETE", "0"
) != "0"


def _between(hash_: int, start: int, end: int) -> bool:
    """Half-open wrap-around range [start, end).

    Deliberate deviation: the reference's between_cmp
    (migration.rs:54-60) inverts the wrap branch
    (``hash < start || hash >= end``), which matches EVERY hash once a
    migration range wraps the ring origin — a delete action then wipes
    the whole collection on that shard.  We use the same semantics as
    the ring's is_between (shards.rs:103-109) instead."""
    if end < start:
        return hash_ >= start or hash_ < end
    return start <= hash_ < end


def _in_migration_range(hash_: int, start: int, end: int) -> bool:
    """Ownership-convention range membership: (start, end].

    Migration plans carry raw shard hashes and ownership is
    end-INCLUSIVE — the first shard with hash >= h owns h (owns_key /
    the client walk), so shard S owns (pred, S].  Feeding the raw
    hashes through the half-open [start, end) filter drops a key that
    hashes exactly onto S (owned, never migrated) and over-sends one
    that hashes exactly onto pred.  Same +1-shift convention as the
    anti-entropy plane (shard.py _in_ae_range); the reference applies
    its migration ranges unshifted (migration.rs:54-60 over raw
    plan hashes) and inherits the boundary hole — found by a
    membership fuzz test."""
    return _between((hash_ - 1) & 0xFFFFFFFF, start, end)


def _journal_path(my_shard, collection_name: str) -> Optional[str]:
    if not my_shard.config.dir:
        return None
    return os.path.join(
        my_shard.config.dir,
        f"migration-{my_shard.id}-{collection_name}.json",
    )


def _target_name(my_shard, ra) -> Optional[str]:
    """Ring-entry NAME of a SEND target, for the journal: connections
    don't survive a restart, names do (resume re-resolves them against
    the then-current ring)."""
    if ra.connection is None:
        return None
    for s in my_shard.shards:
        if s.connection is ra.connection:
            return s.name
    return None


async def migrate_actions(
    my_shard,
    collection_name: str,
    tree: LSMTree,
    ranges_and_actions: List,
    plan_epoch: Optional[int] = None,
    cursors: Optional[List[Optional[bytes]]] = None,
) -> None:
    from .shard import MigrationAction

    n = len(ranges_and_actions)
    cursor: List[Optional[bytes]] = (
        list(cursors) + [None] * (n - len(cursors))
        if cursors
        else [None] * n
    )
    done = [False] * n
    rate = getattr(my_shard.config, "migration_keys_per_sec", 0)
    journal_path = _journal_path(my_shard, collection_name)

    def write_journal() -> None:
        if journal_path is None:
            return
        arcs = [
            {
                "start": ra.start,
                "end": ra.end,
                "action": ra.action,
                "target": _target_name(my_shard, ra),
                "cursor": (
                    cursor[i].hex()
                    if cursor[i] is not None
                    else None
                ),
                "done": done[i],
            }
            for i, ra in enumerate(ranges_and_actions)
        ]
        tmp = journal_path + ".tmp"
        try:
            with open(tmp, "w") as f:  # lint: allow(async-blocking)
                json.dump(
                    {
                        "collection": collection_name,
                        "epoch": plan_epoch,
                        "arcs": arcs,
                    },
                    f,
                )
            os.replace(tmp, journal_path)
        except OSError as e:
            # A full/failing disk must not abort the stream itself —
            # worst case a restart restreams (the pre-journal
            # behavior).
            log.warning("migration journal write failed: %s", e)

    completed = False
    aborted = False
    stream = None
    # The soft-overload gate is paid ONCE per migration run, not per
    # page: each page is a deliberately small unit, and re-paying the
    # full bounded delay for every one would multiply it by the page
    # count (observed: a near-full idle memtable held the gate at its
    # max for each page and starved the whole handoff).
    first_unit = True
    try:
        write_journal()
        for i, ra in enumerate(ranges_and_actions):
            if ra.action == MigrationAction.SEND and isinstance(
                ra.connection, RemoteShardConnection
            ):
                stream = await ra.connection.open_stream()
            start_after = cursor[i]
            more = True
            while more:
                if (
                    plan_epoch is not None
                    and my_shard.membership_epoch != plan_epoch
                ):
                    # Fenced: a newer membership change re-planned
                    # from the current ring; these arcs are its
                    # responsibility now.
                    my_shard.migrations_cancelled += 1
                    aborted = True
                    return
                # One page = one background unit under the share
                # scheduler: bulk migration defers to live serving
                # traffic (glommio bg-queue parity) instead of racing
                # it for the loop.  (start, end] plan arcs shift by +1
                # into scan_page's raw-hash [start, end) convention —
                # the same boundary fix _in_migration_range encodes.
                async with my_shard.scheduler.bg_slice(
                    gated=first_unit
                ):
                    first_unit = False
                    entries, more = await tree.scan_page(
                        (ra.start + 1) & 0xFFFFFFFF,
                        (ra.end + 1) & 0xFFFFFFFF,
                        start_after,
                        None,
                        MIGRATION_BATCH_ENTRIES,
                        MIGRATION_BATCH_BYTES,
                        True,
                    )
                    for key, value, ts in entries:
                        key, value = bytes(key), bytes(value)
                        if ra.action == MigrationAction.DELETE:
                            if _MIGRATION_DELETE:
                                await tree.delete(key)
                        else:
                            msg = ShardEvent.set(
                                collection_name, key, value, ts
                            )
                            if stream is not None:
                                await stream.send(msg)
                            elif isinstance(
                                ra.connection, LocalShardConnection
                            ):
                                await ra.connection.send_message(
                                    my_shard.id, msg
                                )
                            my_shard.keys_migrated += 1
                            my_shard.bytes_migrated += len(value)
                    if entries:
                        start_after = cursor[i] = bytes(
                            entries[-1][0]
                        )
                write_journal()
                if rate > 0 and entries:
                    # Open-loop pacing on top of the bg gate.
                    await asyncio.sleep(len(entries) / rate)
            done[i] = True
            write_journal()
            if stream is not None:
                stream.close()
                stream = None
        completed = True
    except asyncio.CancelledError:
        # Hard fence (task cancel): same story as the epoch abort.
        aborted = True
        raise
    finally:
        if stream is not None:
            stream.close()
        if journal_path is not None and (completed or aborted):
            # Done or superseded: either way the journal must not
            # resurrect this plan after a restart.  Only a CRASH
            # leaves it behind, which is exactly the resume case.
            # (Unlink of a tiny just-written file: not worth an
            # executor hop on the teardown path.)
            try:
                os.remove(journal_path)  # lint: allow(async-blocking)
            except OSError:
                pass


async def resume_migrations(my_shard) -> None:
    """Pick up migration journals a crash/restart left behind and
    restream their unfinished tail (done arcs skip entirely; the
    in-progress arc resumes past its cursor).  Conservative: only
    SEND arcs whose target NAME still sits on the current ring are
    resumed — a target that left gets covered by that membership
    change's own re-plan, and DELETE arcs are dropped (space-only
    cost; the next plan or an operator re-derives them).  Epochs
    reset at boot, so validation is by target existence, not epoch."""
    from .shard import MigrationAction, RangeAndAction

    d = my_shard.config.dir
    if not d or not os.path.isdir(d):
        return
    prefix = f"migration-{my_shard.id}-"
    spawned = False
    for entry in sorted(os.listdir(d)):
        if not entry.startswith(prefix) or not entry.endswith(
            ".json"
        ):
            continue
        path = os.path.join(d, entry)
        try:
            with open(path) as f:  # lint: allow(async-blocking)
                state = json.load(f)
        except (OSError, ValueError) as e:
            log.warning("unreadable migration journal %s: %s", path, e)
            try:
                os.remove(path)  # lint: allow(async-blocking)
            except OSError:
                pass
            continue
        name = state.get("collection")
        col = my_shard.collections.get(name)
        by_name = {}
        for s in my_shard.shards:
            by_name.setdefault(s.name, s)
        ranges: List = []
        cursors: List[Optional[bytes]] = []
        if col is not None:
            for arc in state.get("arcs", []):
                if arc.get("done"):
                    continue
                if arc.get("action") != MigrationAction.SEND:
                    continue
                tgt = by_name.get(arc.get("target"))
                if tgt is None:
                    continue
                ranges.append(
                    RangeAndAction(
                        int(arc["start"]),
                        int(arc["end"]),
                        MigrationAction.SEND,
                        tgt.connection,
                    )
                )
                c = arc.get("cursor")
                cursors.append(bytes.fromhex(c) if c else None)
        if not ranges:
            try:
                os.remove(path)  # lint: allow(async-blocking)
            except OSError:
                pass
            continue
        my_shard.migrations_resumed += 1
        epoch = my_shard.membership_epoch

        async def run(name=name, tree=col.tree, r=ranges, cur=cursors):
            try:
                await migrate_actions(
                    my_shard,
                    name,
                    tree,
                    r,
                    plan_epoch=epoch,
                    cursors=cur,
                )
            except asyncio.CancelledError:
                pass
            except Exception as e:
                log.error(
                    "error resuming migration of %s: %s", name, e
                )
            my_shard.flow.notify(FlowEvent.DONE_MIGRATION)

        task = my_shard.spawn(run())
        my_shard._migration_tasks.add(task)
        task.add_done_callback(my_shard._migration_task_done)
        spawned = True
        log.info(
            "resuming migration of %s: %d arc(s)", name, len(ranges)
        )
    if spawned:
        # Epoch fence up for the resumed window, exactly like a fresh
        # spawn_migration_tasks.
        my_shard._refresh_dataplane_ownership()
