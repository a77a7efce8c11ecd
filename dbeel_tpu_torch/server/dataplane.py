"""Native serving data plane — the C fast path for db-server frames.

The architecture of a C++ host runtime owning I/O with Python as a
thin API veneer, applied to the serving path: one C call
per request frame covers msgpack parse → ownership check → arena
memtable set → WAL append (plus memtable-hit gets), replacing ~60-90µs
of interpreted Python per op with a few µs of native code — the role
the reference's compiled handler plays (src/tasks/db_server.rs:395-454).

Python remains the brain: only RF=1 collections with the arena
memtable and no wal-sync are registered, and ANY non-trivial condition
(other request types, unowned keys, full memtables, replica traffic,
malformed frames, sstable reads, tombstones) makes the C side return
PUNT and the frame re-runs through the unchanged Python handler, so
semantics and error formatting are identical on both paths.
"""

from __future__ import annotations

import ctypes
import logging
import os
from typing import Optional

log = logging.getLogger(__name__)


class _TableDesc(ctypes.Structure):
    """Mirrors the C FastTable descriptor (dbeel_native.cpp).  The
    bloom/prefix fields are raw buffer addresses; the DataPlane keeps
    the owning Python objects alive in _table_refs until the next
    registration for the collection."""

    _fields_ = [
        ("data_fd", ctypes.c_int32),
        ("index_fd", ctypes.c_int32),
        ("entry_count", ctypes.c_uint64),
        ("bloom_bits", ctypes.c_uint64),
        ("bloom_nbits", ctypes.c_uint64),
        ("bloom_k", ctypes.c_uint32),
        ("stride", ctypes.c_uint32),
        ("p1", ctypes.c_uint64),
        ("p2", ctypes.c_uint64),
        ("n_samples", ctypes.c_uint64),
        # CRC sidecar: borrowed u32[] page-CRC arrays from
        # checksums.TableSums; 0 = no sidecar (legacy table, probes
        # serve unverified — the Python read path's rule).
        ("data_size", ctypes.c_uint64),
        ("sums_data", ctypes.c_uint64),
        ("sums_index", ctypes.c_uint64),
        ("n_sums_data", ctypes.c_uint64),
        ("n_sums_index", ctypes.c_uint64),
    ]

# Full wire response for a successful set/delete: u32-LE length +
# msgpack "OK" + RESPONSE_BYTES trailing byte (db_server.rs:405-428).
OK_RESPONSE = b"\x04\x00\x00\x00\xa2OK\x02"

# Field widths of the coordinator-assist get trailer header
# dbeel_dp_handle_coord appends after the peer frame.  The parse
# derives its offsets FROM these widths, so a layout change that
# forgets to move an offset cannot exist on this side; the C emitter
# static_asserts the same sum next to its literal offsets, and the
# wire-parity lint compares the totals — a one-sided change is
# exactly the 17->25B stale-ABI misparse once guarded at
# runtime.
_TRAILER_HIT = 1  # u8 hit flag
_TRAILER_VLEN = 4  # u32 value length
_TRAILER_TS = 8  # i64 entry timestamp
_TRAILER_KLEN = 4  # u32 key length
_TRAILER_DEADLINE = 8  # i64 propagated deadline_ms
_OFF_VLEN = _TRAILER_HIT
_OFF_TS = _OFF_VLEN + _TRAILER_VLEN
_OFF_KLEN = _OFF_TS + _TRAILER_TS
_OFF_DEADLINE = _OFF_KLEN + _TRAILER_KLEN
# Literal (the wire-parity lint compares it against the C constexpr
# textually); the assert ties it to the widths above so it cannot
# drift from the offsets the parse actually uses.
COORD_GET_TRAILER_HDR = 25
assert COORD_GET_TRAILER_HDR == _OFF_DEADLINE + _TRAILER_DEADLINE

_GET_BUF_CAP = 256 << 10
# The native planes return -2 with *out_len = required bytes when a
# (side-effect-free) frame only failed for buffer room — grow and
# retry natively instead of punting to the interpreted path.  Bound
# matches the C kDpHardMax plus envelope slack.
_GET_BUF_HARD_CAP = (16 << 20) + (256 << 10)  # kDpHardMax + slack
# DBEEL_DP_NO_GROW=1 disables the grow-and-retry (A/B benching of the
# big-value punt cliff); "0"/"" keep it enabled.
_GROW_ENABLED = os.environ.get("DBEEL_DP_NO_GROW", "0") in ("", "0")


def _switch_on(name: str) -> bool:
    """False when the kill switch ``name`` is set to anything but
    "0"/""."""
    return os.environ.get(name, "0") in ("", "0")


class DataPlane:
    """Per-shard native fast path.  Lifecycle:

    * the shard registers every eligible collection's write state
      (active/flushing memtable handles + native WAL handle) and
      re-registers on every flush swap (LSMTree.write_state_listener);
    * ring changes recompute the replica-0 ownership range;
    * the db server offers each frame via try_handle() before falling
      back to the async Python path.
    """

    def __init__(self, lib) -> None:
        self._lib = lib
        self._handle = lib.dbeel_dp_new()
        if not self._handle:
            raise MemoryError("dataplane allocation failed")
        self._trees = {}  # name -> LSMTree (flush spawning)
        # Slot-indexed names mirroring the C collection vector (both
        # append on register and erase on unregister): O(1) slot ->
        # name on the per-request paths, no list materialization.
        self._slots: list = []
        self._table_refs = {}  # name -> borrowed-buffer keepalives
        self._table_fps = {}  # name -> registry fingerprint (skip no-ops)
        self._get_buf = ctypes.create_string_buffer(_GET_BUF_CAP)
        self._buf_cap = _GET_BUF_CAP
        self._out_len = ctypes.c_uint32(0)
        # The environment's A/B switches ("0"/"" keep a path on); the
        # library carries every symbol these paths call (storage/native.py
        # refuses one that does not), so there are no ABI gates.
        # DBEEL_DP_NO_TABLES=1: gets punt to Python on a memtable miss
        # instead of searching the sstables natively.
        self._has_tables = _switch_on("DBEEL_DP_NO_TABLES")
        # DBEEL_DP_NO_SHARD_PLANE=1: replica-plane frames punt.
        self._has_shard_plane = _switch_on("DBEEL_DP_NO_SHARD_PLANE")
        # DBEEL_DP_NO_COORD=1: RF>1 client ops take the interpreted
        # coordinator.
        self._has_coord = _switch_on("DBEEL_DP_NO_COORD")
        self._shed_armed = False
        # DBEEL_DP_NO_MULTI=1 punts client MULTI frames to the Python
        # fallback (A/B gate for the native-floor bench: the
        # interpreted multi path measured same-session on an
        # otherwise identical server).
        if not _switch_on("DBEEL_DP_NO_MULTI"):
            lib.dbeel_dp_set_multi(self._handle, 0)
        # Native-plane timing (tracing plane): coarse per-verb
        # stage counters (parse / storage work / reply, monotonic ns)
        # stamped inside the C handlers when armed — the latency
        # accounting for ops that never touch Python.
        self._trace_armed = False
        # CRC sidecar verification in the C table probes
        # (DBEEL_DP_VERIFY=0 disables; follows the Python read path's
        # DBEEL_NO_CHECKSUMS master switch otherwise).  Moot where
        # preadv2/RWF_NOWAIT is absent (every probe punts before
        # reading); required wherever it exists, or the native read
        # path would be the one unverified surface.
        self._verify_crc = False
        if os.environ.get("DBEEL_DP_VERIFY", "1") not in ("0",):
            from ..storage import checksums

            self._verify_crc = checksums.verification_enabled()
            if self._verify_crc:
                lib.dbeel_dp_set_verify(self._handle, 1)

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.dbeel_dp_free(handle)
            self._handle = None

    # ---- registration ------------------------------------------------

    @staticmethod
    def tree_eligible(tree) -> bool:
        """Registration requires the native arena memtable (its handle
        IS the C-side memtable).  Write fast-pathing additionally
        requires a native WAL appender — see _write_wal_handle; trees
        that fail only the write conditions still register for native
        GETS (memtable probe + sstable search) with a null WAL, which
        makes the C write path punt."""
        active = getattr(tree, "_active", None)
        return getattr(active, "_handle", None) is not None

    @staticmethod
    def _write_wal_handle(tree):
        wal = getattr(tree, "_wal", None)
        if wal is None or getattr(wal, "_native", None) is None:
            return None
        if tree.wal_sync and getattr(wal, "_syncer", None) is None:
            # Durable mode without the native group-commit thread:
            # writes must punt to the Python coalescer.
            return None
        from ..storage import file_io

        if file_io._faults:
            # Disk-fault seam armed (tests / chaos drills): the C
            # appender would bypass the Python-side injection AND the
            # degraded-mode escalation it must trigger — punt writes
            # to the guarded Python path.  Production never pays this
            # (the dict is empty; one truthiness check).
            return None
        return wal._native

    def register_tree(
        self, name: str, tree, client_plane: bool = True
    ) -> None:
        """client_plane=False (RF>1 collections) registers for the
        replica plane only: peer set/delete/get messages are served
        natively, but client-facing frames punt to Python, which owns
        the replication/consistency fan-out."""
        if not client_plane and not self._has_shard_plane:
            # Replica-plane registration with the replica plane
            # switched off: nothing may be served natively.
            self.unregister(name)
            return
        if not self.tree_eligible(tree):
            self.unregister(name)
            return
        nm = name.encode()
        flushing = getattr(tree, "_flushing", None)
        rc = self._lib.dbeel_dp_register(
            self._handle,
            nm,
            len(nm),
            ctypes.c_void_p(tree._active._handle),
            ctypes.c_void_p(
                flushing._handle
                if getattr(flushing, "_handle", None)
                else None
            ),
            ctypes.c_void_p(self._write_wal_handle(tree)),
            tree.capacity,
            1 if client_plane else 0,
        )
        if rc < 0:
            # Failed (re-)registration must also clear any C-side
            # entry: a stale slot would keep old memtable/WAL pointers
            # alive past their owners (use-after-free on the next
            # fast write) and desynchronize slot indexing.
            log.warning("dataplane registration failed for %s", name)
            self.unregister(name)
            return
        # Shard-plane writes with ts <= the tree's flush watermark
        # punt to the read-guarded Python apply (an old-ts entry above
        # a flushed newer one would be served by first-match point
        # reads).  Refreshed here because registration re-runs on
        # every flush swap.
        self._lib.dbeel_dp_set_watermark(
            self._handle,
            nm,
            len(nm),
            int(getattr(tree, "max_flushed_ts", 0)),
        )
        self._trees[name] = tree
        if name not in self._slots:
            self._slots.append(name)
        if self._slots.index(name) != rc:
            # Slot bookkeeping diverged from the C vector (should be
            # impossible): disable the flush lookup safely.
            log.error(
                "dataplane slot mismatch for %s (rc=%d)", name, rc
            )
            self.unregister(name)
            return
        tree.write_state_listener = (
            lambda t, n=name, cp=client_plane: self.register_tree(
                n, t, cp
            )
        )
        self._register_tables(name, tree)

    def _register_tables(self, name: str, tree) -> None:
        """Mirror the tree's sstable list (newest first) into the C
        registry so gets that miss the memtables resolve natively.
        Runs on the shard loop thread (write_state_listener fires on
        flush commit, compaction swap, and read-index warm
        completion); on ANY irregularity the registry is invalidated
        so the C side punts instead of mis-reporting absence."""
        if not self._has_tables:
            return
        nm = name.encode()
        lib = self._lib
        try:
            tables = list(reversed(tree._sstables.tables))
            # Most write-state notifications (memtable swaps, warm
            # completions of already-registered tables) don't change
            # the registry inputs: skip the dup/close syscall churn
            # when the (table, index-built, sidecar) fingerprint is
            # unchanged.
            fp = tuple(
                (
                    id(t),
                    t._fast is not None,
                    t._sparse is not None,
                    t.sums is not None,
                )
                for t in tables
            )
            if self._table_fps.get(name) == fp:
                return
            descs = (_TableDesc * max(1, len(tables)))()
            refs = []
            for i, t in enumerate(tables):
                d = descs[i]
                fd_d = t._data._fd
                fd_i = t._index._fd
                if fd_d < 0 or fd_i < 0:
                    raise ValueError(f"closed fds on sstable {t.index}")
                d.data_fd = fd_d
                d.index_fd = fd_i
                d.entry_count = t.entry_count
                bloom = t.bloom
                if bloom is not None:
                    d.bloom_bits = bloom.bits.ctypes.data
                    d.bloom_nbits = bloom.num_bits
                    d.bloom_k = bloom.num_hashes
                fast, sparse = t._fast, t._sparse
                p1 = p2 = None
                if fast is not None:
                    p1, p2 = fast[0], fast[1]
                    d.stride = 1
                elif sparse is not None:
                    p1, p2, d.stride = sparse
                if p1 is not None and len(p1):
                    d.p1 = p1.buffer_info()[0]
                    d.p2 = p2.buffer_info()[0]
                    d.n_samples = len(p1)
                else:
                    d.stride = 0
                sums_ref = None
                sums = getattr(t, "sums", None)
                if self._verify_crc and sums is not None:
                    # Borrowed contiguous u32 CRC arrays for the C
                    # probe verifier (parity with checksums.page_crcs
                    # — golden-tested via dbeel_crc32_pages).  The
                    # deserialize path hands array('I') already; the
                    # write path hands plain lists — normalize once.
                    import array as _array

                    dc = sums.data_crcs
                    if not isinstance(dc, _array.array):
                        dc = _array.array("I", dc)
                    ic = sums.index_crcs
                    if not isinstance(ic, _array.array):
                        ic = _array.array("I", ic)
                    d.data_size = t.data_size
                    if len(dc):
                        d.sums_data = dc.buffer_info()[0]
                        d.n_sums_data = len(dc)
                    if len(ic):
                        d.sums_index = ic.buffer_info()[0]
                        d.n_sums_index = len(ic)
                    sums_ref = (dc, ic)
                refs.append((t, bloom, fast, sparse, sums_ref))
            rc = lib.dbeel_dp_set_tables(
                self._handle, nm, len(nm), descs, len(tables)
            )
            if rc == 0:
                self._table_refs[name] = refs
                self._table_fps[name] = fp
            else:
                # C kept (but invalidated) the old registry — keep the
                # old refs so its fd-close sweep stays safe.
                self._table_fps.pop(name, None)
        except Exception:
            log.exception("dataplane table registration for %s", name)
            self._table_fps.pop(name, None)
            lib.dbeel_dp_set_tables(self._handle, nm, len(nm), None, -1)

    def unregister(self, name: str) -> None:
        nm = name.encode()
        self._lib.dbeel_dp_unregister(self._handle, nm, len(nm))
        if name in self._slots:
            self._slots.remove(name)
        tree = self._trees.pop(name, None)
        self._table_refs.pop(name, None)
        # Drop the fingerprint too: a re-created collection with the
        # same name starts with a FRESH (tables_valid=false) C entry,
        # and a stale matching fingerprint would skip the set_tables
        # call that validates it.
        self._table_fps.pop(name, None)
        if tree is not None:
            tree.write_state_listener = None

    def set_ownership(self, mode: int, lo: int = 0, hi: int = 0) -> None:
        """mode 0 = punt everything, 1 = own the whole ring (single
        shard), 2 = cyclic range (lo, hi] for replica_index 0."""
        self._lib.dbeel_dp_set_ownership(self._handle, mode, lo, hi)

    def set_overload(self, level: int) -> None:
        """Mirror the governor's level into C: at hard (2)
        the client plane answers data verbs with the prebuilt
        retryable Overloaded response instead of feeding the backlog
        — shed frames never reach the Python dispatcher."""
        self._lib.dbeel_dp_set_overload(self._handle, level)

    def set_class_levels(self, levels) -> None:
        """Mirror the governor's PER-CLASS levels into C (QoS
        plane): the native shed gate checks the frame's stamped
        class against its own level, so a batch flood is refused in C
        while interactive frames keep serving natively."""
        l = list(levels)[:3] + [0, 0, 0]
        self._lib.dbeel_dp_set_class_levels(
            self._handle, l[0], l[1], l[2]
        )

    def sheds_by_class(self):
        """Native per-class shed counters."""
        buf = (ctypes.c_uint64 * 3)()
        self._lib.dbeel_dp_sheds_by_class(self._handle, buf)
        return [int(buf[i]) for i in range(3)]

    def admits_by_class(self):
        """Native lane accounting: per-class
        counters of frames SERVED by the C planes —
        ``(client_plane[3], peer_plane[3])``: without them the
        ``get_stats.qos`` lane counters (admitted/peer_ops) cover
        interpreted frames only, and the native fast path is invisible
        to per-class accounting."""
        buf = (ctypes.c_uint64 * 6)()
        self._lib.dbeel_dp_admits_by_class(self._handle, buf)
        return (
            [int(buf[i]) for i in range(3)],
            [int(buf[3 + i]) for i in range(3)],
        )

    def set_overload_responses(
        self, shed_resp: bytes, deadline_resp: bytes
    ) -> None:
        """Install the COMPLETE wire responses (u32-LE length +
        payload + type byte) for native sheds and expired-deadline
        drops, packed by the caller with the Python msgpack encoder
        so the two paths stay byte-identical."""
        self._lib.dbeel_dp_set_overload_resp(
            self._handle,
            shed_resp,
            len(shed_resp),
            deadline_resp,
            len(deadline_resp),
        )
        self._shed_armed = True

    def set_trace(self, on: bool) -> None:
        """Arm/disarm the native per-verb stage counters.  Off (the
        default) costs literally nothing on the serving path; armed,
        each natively-served op pays a few vDSO clock reads."""
        self._lib.dbeel_dp_set_trace(self._handle, 1 if on else 0)
        self._trace_armed = bool(on)

    # Snapshot layout: 4 verb classes x (ops, parse_ns, work_ns,
    # reply_ns) — keep in lockstep with kTraceClasses/kTraceSlots in
    # dbeel_native.cpp.
    _TRACE_CLASSES = ("write", "get", "multi", "shard")

    def trace_stats(self) -> Optional[dict]:
        """Per-verb-class native stage attribution (µs totals + op
        counts), or None when the snapshot comes back short."""
        n = len(self._TRACE_CLASSES) * 4
        buf = (ctypes.c_uint64 * n)()
        got = self._lib.dbeel_dp_trace_snapshot(self._handle, buf, n)
        if got < n:
            return None
        out = {"armed": int(self._trace_armed)}
        for i, cls in enumerate(self._TRACE_CLASSES):
            ops, parse_ns, work_ns, reply_ns = buf[i * 4 : i * 4 + 4]
            out[cls] = {
                "ops": int(ops),
                "parse_us": int(parse_ns) // 1000,
                "work_us": int(work_ns) // 1000,
                "reply_us": int(reply_ns) // 1000,
            }
        return out

    @property
    def shed_armed(self) -> bool:
        """True once the native hard-overload gate can answer sheds
        itself (the responses installed): the Python
        dispatcher may then leave shedding of parseable data verbs
        entirely to the C side."""
        return self._shed_armed

    # ---- serving -----------------------------------------------------

    # Verb codes in flags bits 24..26 of a native drop/shed.
    _VERBS = {1: "set", 2: "get", 3: "delete", 4: "multi_set",
              5: "multi_get"}

    def try_handle(self, frame: bytes) -> Optional[tuple]:
        """Returns (response_bytes, keepalive, tree_needing_flush, op,
        defer, extra) when the frame was fully handled natively; None
        to punt.  ``defer`` is None, or ``(syncer, ticket)`` for
        wal-sync trees — the caller must park the response until the
        syncer's watermark covers the ticket.  ``extra`` is None for
        single ops, ``("multi", n)`` for a batched frame of n sub-ops
        (caller records batch metrics), ``("shed",)`` for a native
        hard-overload shed, ``("deadline",)`` for an expired-client-
        deadline drop — the caller mirrors the governor/metrics
        bookkeeping the Python path would have done."""
        flags = self._call_grow(self._lib.dbeel_dp_handle, frame)
        if flags < 0:
            return None
        keepalive = bool(flags & 1)
        cls = (flags >> 6) & 3
        if cls == 3:
            # Dropped natively (out holds the prebuilt retryable
            # Overloaded response): shed at hard overload (bit 27) or
            # client deadline expired before dispatch.
            return (
                self._get_buf[: self._out_len.value],
                keepalive,
                None,
                self._VERBS.get((flags >> 24) & 7, "invalid"),
                None,
                ("shed",) if flags & (1 << 27) else ("deadline",),
            )
        if cls:
            # MULTI_SET (1) / MULTI_GET (2): per-sub-op results (or
            # the whole-frame apply error, bit4) already packed in
            # the out buffer; sub-op count rides bits 32+.
            op = "multi_set" if cls == 1 else "multi_get"
            return (
                self._get_buf[: self._out_len.value],
                keepalive,
                self._flush_tree_from_flags(flags),
                op,
                self._sync_defer_from_flags(flags, 0x20),
                ("multi", (flags >> 32) & 0x3FFF),
            )
        if flags & 4:  # get served from a memtable/sstable probe
            return (
                self._get_buf[: self._out_len.value],
                keepalive,
                None,
                "get",
                None,
                None,
            )
        op = "delete" if flags & 8 else "set"
        # bit4: entry applied but the WAL append failed — out holds
        # the complete error response; the frame must not re-run.
        resp = (
            self._get_buf[: self._out_len.value]
            if flags & 0x10
            else OK_RESPONSE
        )
        return (
            resp,
            keepalive,
            self._flush_tree_from_flags(flags),
            op,
            self._sync_defer_from_flags(flags, 0x20),
            None,
        )

    def _call_grow(self, fn, frame: bytes) -> int:
        """One native-plane call with the grow-and-retry protocol:
        -2 means the frame failed ONLY for response-buffer room (big
        value; emitted before any side effect) and *out_len holds the
        required size — grow the persistent buffer and re-run the
        frame natively rather than punting to the slower
        interpreted path (measured 2.3x on sstable-resident 1 MiB
        gets).  The buffer keeps its high-water size for
        the DATAPLANE's lifetime — one per shard, every connection —
        bounded by _GET_BUF_HARD_CAP.
        Flattens the punt cliff vs the reference's any-size compiled
        path (entry_writer.rs:72-74)."""
        flags = fn(
            self._handle,
            frame,
            len(frame),
            self._get_buf,
            self._buf_cap,
            ctypes.byref(self._out_len),
        )
        if flags == -2:
            needed = self._out_len.value
            if needed > _GET_BUF_HARD_CAP or not _GROW_ENABLED:
                return -1
            new_cap = self._buf_cap
            while new_cap < needed:
                new_cap <<= 1
            # Clamp the doubling to the hard cap (still >= needed):
            # this buffer lives for the DATAPLANE's lifetime — one per
            # shard, shared by every connection — so it must never
            # exceed the documented bound.
            new_cap = min(new_cap, _GET_BUF_HARD_CAP)
            self._get_buf = ctypes.create_string_buffer(new_cap)
            self._buf_cap = new_cap
            flags = fn(
                self._handle,
                frame,
                len(frame),
                self._get_buf,
                self._buf_cap,
                ctypes.byref(self._out_len),
            )
            if flags == -2:
                return -1  # still too small: genuine punt
        return flags

    def _sync_defer_from_flags(self, flags: int, bit: int):
        """(syncer, ticket) for a deferred durable ack, or None.  The
        ticket is read immediately after the native call on the loop
        thread, so it is exactly this request's append sequence."""
        if not flags & bit:
            return None
        col_idx = (flags >> 8) & 0xFFFF
        if not 0 <= col_idx < len(self._slots):
            return None
        tree = self._trees.get(self._slots[col_idx])
        syncer = getattr(getattr(tree, "_wal", None), "_syncer", None)
        if syncer is None:  # racing a WAL swap: ack immediately
            return None
        return (syncer, syncer.ticket())

    def _flush_tree_from_flags(self, flags: int):
        """Decode bit1 (memtable-now-full) + the slot index in bits
        8..23 into the tree whose flush the caller must spawn.  Slot
        order matches registration order (the C vector appends; the
        mismatch guard in register_tree keeps dict and vector
        aligned)."""
        if not flags & 2:
            return None
        col_idx = (flags >> 8) & 0xFFFF
        if 0 <= col_idx < len(self._slots):
            return self._trees.get(self._slots[col_idx])
        return None

    def try_handle_coord(
        self, frame: bytes
    ) -> Optional[tuple]:
        """Coordinator fast path for one RF>1 client op: the C side
        parses the request map, performs the local half (writes:
        memtable+WAL with a server-assigned timestamp; gets:
        memtable+sstable lookup), and returns the fully packed peer
        frame (4B-LE length + msgpack ShardRequest) to fan out
        verbatim.  Returns None to punt (nothing applied), or
        (op, peer_frame, keepalive, flush_tree, consistency,
        timeout_ms, collection_name, local_entry, key, error_resp) —
        op is "set"/"delete"/"get"; consistency is None when the
        request didn't carry a usable int; timeout_ms is 0 for
        absent/falsy (caller applies the default); local_entry is
        None except for gets, where it is ((value_bytes, ts)) for a
        hit (tombstone = empty value) or ("miss",) for authoritative
        absence; key is the raw wire key for gets (so the caller
        never unpacks the peer frame); error_resp, when not None, is
        the complete client error payload (entry applied but WAL
        append failed) — send it, skip the fan-out; defer (11th) is
        None or (syncer, ticket): under wal-sync the local ack only
        counts once the watermark covers the ticket, so await it
        alongside the quorum fan-out; deadline_ms (12th) is the
        propagated wall-clock budget the C side stamped on the peer
        frame (gets only) — the Python-packed digest round must carry
        the same budget."""
        if not self._has_coord:
            return None
        flags = self._call_grow(
            self._lib.dbeel_dp_handle_coord, frame
        )
        if flags < 0:
            return None
        out = self._get_buf[: self._out_len.value]
        col_idx = (flags >> 8) & 0xFFFF
        col_name = (
            self._slots[col_idx]
            if 0 <= col_idx < len(self._slots)
            else None
        )
        keepalive = bool(flags & 1)
        flush_tree = self._flush_tree_from_flags(flags)
        if flags & 0x10:
            # out = u32-LE length + error payload + type byte; the
            # caller's response writer re-adds the length prefix.
            op = "delete" if flags & 4 else "set"
            return (
                op,
                b"",
                keepalive,
                flush_tree,
                None,
                0,
                col_name,
                None,
                None,
                out[4:],
                None,
                None,
            )
        peer_len = 4 + int.from_bytes(out[:4], "little")
        peer_frame = out[:peer_len]
        local_entry = None
        key = None
        deadline_ms = None
        if flags & 8:
            op = "get"
            # COORD_GET_TRAILER_HDR-byte trailer header:
            # hit flag, value len, ts, key len, then the propagated
            # wall-clock deadline the C side stamped on the peer
            # frame — the digest round (whose frame Python packs)
            # must carry the SAME budget.  Layout changes bump the
            # constant IN LOCKSTEP with kCoordGetTrailerHdr in
            # dbeel_native.cpp (wire-parity lint compares them — the
            # 17->25B stale-ABI misparse class).
            hdr_end = COORD_GET_TRAILER_HDR
            trailer = out[peer_len:]
            vlen = int.from_bytes(
                trailer[_OFF_VLEN : _OFF_VLEN + _TRAILER_VLEN],
                "little",
            )
            klen = int.from_bytes(
                trailer[_OFF_KLEN : _OFF_KLEN + _TRAILER_KLEN],
                "little",
            )
            deadline_ms = int.from_bytes(
                trailer[_OFF_DEADLINE:hdr_end], "little", signed=True
            )
            if trailer[0]:
                ts = int.from_bytes(
                    trailer[_OFF_TS : _OFF_TS + _TRAILER_TS],
                    "little",
                    signed=True,
                )
                local_entry = (trailer[hdr_end : hdr_end + vlen], ts)
            else:
                local_entry = ("miss",)
                vlen = 0
            key = trailer[hdr_end + vlen : hdr_end + vlen + klen]
        else:
            op = "delete" if flags & 4 else "set"
        cons_p1 = (flags >> 24) & 0xFF
        return (
            op,
            peer_frame,
            keepalive,
            flush_tree,
            cons_p1 - 1 if cons_p1 else None,
            (flags >> 32) & 0x3FFFFFFF,
            col_name,
            local_entry,
            key,
            None,
            self._sync_defer_from_flags(flags, 0x20),
            deadline_ms,
        )

    def try_handle_shard(
        self, frame: bytes
    ) -> Optional[tuple]:
        """Replica-plane fast path for one remote-shard-protocol
        message (raw msgpack list bytes, no length prefix).  Returns
        (response_frame_or_None, tree_needing_flush, notify_set,
        defer, deadline_dropped) when handled natively — the response
        already carries its 4-byte-LE length prefix; notify_set means
        the caller fires ITEM_SET_FROM_SHARD_MESSAGE (set writes
        only, matching the Python handler); defer is None or
        (syncer, ticket): park the ack (and the notification) until
        the WAL sync watermark covers the ticket; deadline_dropped
        means the frame's propagated budget had expired and the
        response is the native retryable Overloaded error (the caller
        counts the replica deadline drop) — or None to punt to
        handle_shard_message."""
        if not self._has_shard_plane:
            return None
        flags = self._call_grow(
            self._lib.dbeel_dp_handle_shard, frame
        )
        if flags < 0:
            return None
        resp = None
        if flags & 4:
            resp = self._get_buf[: self._out_len.value]
        notify_set = bool(flags & 8) and not bool(flags & 0x20)
        return (
            resp,
            self._flush_tree_from_flags(flags),
            notify_set,
            self._sync_defer_from_flags(flags, 0x40),
            bool(flags & 0x80),
        )

    def stats(self) -> dict:
        out = {
            "fast_sets": int(
                self._lib.dbeel_dp_fast_sets(self._handle)
            ),
            "fast_gets": int(
                self._lib.dbeel_dp_fast_gets(self._handle)
            ),
        }
        if self._has_tables:
            out["fast_table_gets"] = int(
                self._lib.dbeel_dp_fast_table_gets(self._handle)
            )
        if self._has_shard_plane:
            out["fast_replica_ops"] = int(
                self._lib.dbeel_dp_fast_replica_ops(self._handle)
            )
        if self._has_coord:
            out["fast_coord_writes"] = int(
                self._lib.dbeel_dp_fast_coord_writes(self._handle)
            )
            out["fast_coord_gets"] = int(
                self._lib.dbeel_dp_fast_coord_gets(self._handle)
            )
        h = self._handle
        out["fast_multi_sets"] = int(self._lib.dbeel_dp_fast_multi_sets(h))
        out["fast_multi_gets"] = int(self._lib.dbeel_dp_fast_multi_gets(h))
        out["native_sheds"] = int(self._lib.dbeel_dp_native_sheds(h))
        out["native_deadline_drops"] = int(
            self._lib.dbeel_dp_native_deadline_drops(h)
        )
        out["crc_failures"] = int(self._lib.dbeel_dp_crc_failures(h))
        out["verify_crc"] = int(self._verify_crc)
        return out


def create_dataplane() -> Optional[DataPlane]:
    # Master kill switch (A/B gate for the native-floor bench and
    # fallback drills): the server runs the all-Python serving path
    # it would use on a host without the .so.
    if os.environ.get("DBEEL_NO_DATAPLANE", "0") not in ("", "0"):
        return None
    try:
        from ..storage import native as native_mod

        lib = native_mod.load_if_built()
        if lib is None:
            return None
        return DataPlane(lib)
    except Exception:
        log.exception("dataplane unavailable")
        return None
