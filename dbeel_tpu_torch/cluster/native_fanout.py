"""Event-loop bridge for the native quorum fan-out engine.

The coordinator half of RF>1 replication spends its per-op Python
budget on asyncio machinery: two+ tasks, four wait_fors, an
asyncio.wait, and pool bookkeeping per quorum op
(shard.py:_fan_out_to_replicas).  The C engine
(native/src/dbeel_native.cpp QuorumFan) replaces the MECHANISM — one
persistent raw socket per peer node, the packed peer frame written to
every replica socket and acks byte-compared in C, responses drained
by a single selector callback — while Python keeps the replication
BRAIN: quorum counting, error interpretation, max-timestamp merge,
read repair, hinted handoff.  Role parity:
reference src/shards.rs:463-543 (compiled fan-out with
early-ack + background drain) and remote_shard_connection.rs:59-94.

Fallback contract: try_submit() returns None whenever any needed peer
lacks a live stream (first use, reconnect in progress, engine
unavailable) — the caller then runs the unchanged asyncio fan-out,
and this module repairs streams in the background.  Nothing is ever
half-sent: the C submit is all-or-nothing per op.
"""

from __future__ import annotations

import asyncio
import ctypes
import logging
import os
import socket
from typing import List, Optional, Tuple

from . import messages as msgs
from ..errors import DbeelError

log = logging.getLogger(__name__)

_EVBUF_CAP = 1 << 20


class _FanOp:
    __slots__ = (
        "future",
        "acks_needed",
        "results",
        "acks",
        "expected_kind",
        "hint_request_fn",
        "peer_names",
        "pending",
        "deadline",
    )

    def __init__(
        self,
        future,
        acks_needed,
        expected_kind,
        hint_request_fn,
        peer_names,
        deadline,
    ):
        self.future = future
        self.acks_needed = acks_needed
        self.results: List = []
        self.acks = 0
        self.expected_kind = expected_kind
        self.hint_request_fn = hint_request_fn
        self.peer_names = peer_names  # peer_id -> node name
        self.pending = set(peer_names)  # peer ids awaiting a response
        self.deadline = deadline


class QuorumFanout:
    """Per-shard native fan-out engine (loop-thread only)."""

    SWEEP_PERIOD_S = 2.0

    def __init__(self, lib, my_shard) -> None:
        self._lib = lib
        self._shard = my_shard
        self._handle = lib.dbeel_qf_new()
        if not self._handle:
            raise MemoryError("quorum fanout allocation failed")
        self._peer_ids = {}  # address -> peer_id
        self._addrs = {}  # peer_id -> (host, port)
        self._fds = {}  # peer_id -> fd currently registered
        self._names = {}  # peer_id -> node name (latest)
        self._ops = {}  # op_id -> _FanOp
        self._connecting = set()
        self._cap = _EVBUF_CAP
        self._buf = ctypes.create_string_buffer(self._cap)
        self._op_id = ctypes.c_uint64(0)
        self._peer = ctypes.c_int32(0)
        self._kind = ctypes.c_int32(0)
        self._plen = ctypes.c_uint32(0)
        self._loop = None
        self._sweeper = None
        self._closed = False

    # ---- stream management -------------------------------------------

    def _peer_id(self, address: str) -> int:
        pid = self._peer_ids.get(address)
        if pid is None:
            pid = len(self._peer_ids)
            self._peer_ids[address] = pid
            host, port = address.rsplit(":", 1)
            self._addrs[pid] = (host, int(port))
        return pid

    def _spawn_connect(self, pid: int) -> None:
        if pid in self._connecting or self._closed:
            return
        self._connecting.add(pid)
        self._shard.spawn(self._connect(pid))

    async def _connect(self, pid: int) -> None:
        try:
            loop = asyncio.get_event_loop()
            host, port = self._addrs[pid]
            sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            sock.setblocking(False)
            try:
                await asyncio.wait_for(
                    loop.sock_connect(sock, (host, port)),
                    self._shard.config.remote_shard_connect_timeout_ms
                    / 1000,
                )
                sock.setsockopt(
                    socket.IPPROTO_TCP, socket.TCP_NODELAY, 1
                )
            except Exception as e:
                sock.close()
                log.debug("qf connect to %s:%s failed: %s", host, port, e)
                return
            if self._closed:
                sock.close()
                return
            self._drop_stream(pid)  # clear any dead predecessor
            fd = sock.detach()  # engine owns the fd from here
            if self._lib.dbeel_qf_set_stream(self._handle, pid, fd) != 0:
                os.close(fd)
                return
            self._fds[pid] = fd
            loop.add_reader(fd, self._on_readable, pid, fd)
        finally:
            self._connecting.discard(pid)

    def _drop_stream(self, pid: int) -> None:
        """Remove selector registration and close a (dead) stream;
        queued dead events drain to their ops."""
        fd = self._fds.pop(pid, None)
        if fd is not None:
            try:
                asyncio.get_event_loop().remove_reader(fd)
                asyncio.get_event_loop().remove_writer(fd)
            except Exception:
                pass
        self._lib.dbeel_qf_close_stream(self._handle, pid)
        self._drain_events()

    # ---- selector callbacks ------------------------------------------

    def _on_readable(self, pid: int, fd: int) -> None:
        if self._fds.get(pid) != fd:
            return  # stale callback for a replaced stream
        rc = self._lib.dbeel_qf_on_readable(self._handle, pid)
        if rc < 0:
            self._drop_stream(pid)
            return
        if rc > 0:
            self._drain_events()

    def _on_writable(self, pid: int, fd: int) -> None:
        if self._fds.get(pid) != fd:
            return
        rc = self._lib.dbeel_qf_on_writable(self._handle, pid)
        if rc == 1:
            return  # keep the watcher
        try:
            asyncio.get_event_loop().remove_writer(fd)
        except Exception:
            pass
        if rc < 0:
            self._drop_stream(pid)

    # ---- submit -------------------------------------------------------

    def try_submit(
        self,
        framed: bytes,
        connections: List[Tuple[str, object]],
        acks_needed: int,
        expected_ack: bytes,
        expected_kind: str,
        hint_request_fn,
    ) -> Optional[asyncio.Future]:
        """All-or-nothing native fan-out.  Returns the quorum future,
        or None to fall back to the asyncio path (also kicks stream
        repair for whichever peers were missing)."""
        if self._closed or not connections:
            return None
        loop = self._loop
        if loop is None:
            loop = self._loop = asyncio.get_event_loop()
            self._sweeper = self._shard.spawn(self._sweep())
        peer_names = {}
        pids = []
        missing = False
        for name, conn in connections:
            pid = self._peer_id(conn.address)
            self._names[pid] = name
            if not self._lib.dbeel_qf_stream_alive(self._handle, pid):
                self._spawn_connect(pid)
                missing = True
            pids.append(pid)
            peer_names[pid] = name
        if missing:
            return None
        arr = (ctypes.c_int32 * len(pids))(*pids)
        op_id = self._lib.dbeel_qf_submit(
            self._handle,
            framed,
            len(framed),
            arr,
            len(pids),
            expected_ack,
            len(expected_ack),
        )
        if not op_id:
            return None
        fut = loop.create_future()
        op = _FanOp(
            fut,
            acks_needed,
            expected_kind,
            hint_request_fn,
            peer_names,
            loop.time()
            + self._shard.config.remote_shard_read_timeout_ms / 1000,
        )
        self._ops[op_id] = op
        # Parked write bytes (EAGAIN) need a writable watcher; a
        # submit-time connection error already queued dead events.
        for pid in pids:
            if self._lib.dbeel_qf_wants_write(self._handle, pid):
                fd = self._fds.get(pid)
                if fd is not None:
                    loop.add_writer(fd, self._on_writable, pid, fd)
        self._drain_events()
        if op.acks_needed <= 0 and not fut.done():
            fut.set_result(list(op.results))
        return fut

    # ---- event dispatch ----------------------------------------------

    def _drain_events(self) -> None:
        lib = self._lib
        while True:
            rc = lib.dbeel_qf_next_event(
                self._handle,
                ctypes.byref(self._op_id),
                ctypes.byref(self._peer),
                ctypes.byref(self._kind),
                self._buf,
                self._cap,
                ctypes.byref(self._plen),
            )
            if rc == 0:
                break
            if rc == -2:  # payload larger than the buffer: grow
                self._cap = max(
                    self._cap * 2, self._plen.value + 4096
                )
                self._buf = ctypes.create_string_buffer(self._cap)
                continue
            op = self._ops.get(self._op_id.value)
            if op is None:
                continue
            pid = self._peer.value
            kind = self._kind.value
            op.pending.discard(pid)
            if kind == 0:  # byte-identical ack
                if not op.future.done():
                    op.results.append(None)
                    op.acks += 1
            elif kind == 1:  # payload: unpack + interpret
                payload = ctypes.string_at(
                    self._buf, self._plen.value
                )
                try:
                    value = msgs.response_to_result(
                        msgs.unpack_message(payload),
                        op.expected_kind,
                    )
                    if not op.future.done():
                        op.results.append(value)
                        op.acks += 1
                except DbeelError as e:
                    # Application-level error from a LIVE replica —
                    # logged, never a handoff (shard.py parity).
                    log.error("failed response from replica: %s", e)
                except Exception as e:
                    log.error("malformed replica response: %s", e)
            else:  # dead stream before a response: hinted handoff
                name = op.peer_names.get(pid)
                log.error(
                    "unreachable replica %s: stream died", name
                )
                try:
                    self._shard._record_hint(
                        name, op.hint_request_fn()
                    )
                except Exception:
                    log.exception("hint recording failed")
            if (
                not op.future.done()
                and op.acks >= op.acks_needed
            ):
                op.future.set_result(list(op.results))
            if not op.pending:
                if not op.future.done():
                    # Replicas ran out before the ack count: return
                    # what we have (shards.rs:500-528 parity).
                    op.future.set_result(list(op.results))
                del self._ops[self._op_id.value]

    def drop_node(self, addresses) -> None:
        """Kill live streams to a node marked Dead: the queued dead
        events hint and release every in-flight op still waiting on
        it, so the detector bounds the blind window on the native
        plane exactly like the asyncio fan-out's mid-flight
        cancellation (streams reconnect lazily if the node returns)."""
        if self._closed:
            return
        for addr in addresses:
            pid = self._peer_ids.get(addr)
            if pid is not None and self._fds.get(pid) is not None:
                self._drop_stream(pid)

    # ---- stalled-stream sweep ----------------------------------------

    async def _sweep(self) -> None:
        """A replica that stops answering stalls its FIFO (and every
        op queued behind it): past the read timeout, kill the stream
        — dead events then hint and release, and the stream
        reconnects on next use.  Mirrors the asyncio path's
        read_timeout per response."""
        while not self._closed:
            await asyncio.sleep(self.SWEEP_PERIOD_S)
            now = (
                self._loop.time() if self._loop is not None else 0.0
            )
            # A stream is stalled only when its FIFO-HEAD op (lowest
            # pending op id — responses arrive in submit order) has
            # passed its deadline.  Killing on any expired op would
            # dead-event every newer in-flight op still within its
            # own deadline on a stream that is actively progressing,
            # losing their acks and recording spurious hinted
            # handoffs.
            head = {}  # pid -> (op_id, deadline) of its FIFO head
            for op_id, op in self._ops.items():
                for pid in op.pending:
                    cur = head.get(pid)
                    if cur is None or op_id < cur[0]:
                        head[pid] = (op_id, op.deadline)
            for pid, (_op_id, deadline) in head.items():
                if now > deadline:
                    log.error(
                        "replica %s timed out; dropping its stream",
                        self._names.get(pid),
                    )
                    self._drop_stream(pid)

    # ---- lifecycle -----------------------------------------------------

    def stats(self) -> dict:
        if self._closed or not self._handle:
            return {"fast_fanout_ops": None}
        return {
            "fast_fanout_ops": int(
                self._lib.dbeel_qf_fanout_ops(self._handle)
            ),
        }

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._sweeper is not None:
            self._sweeper.cancel()
        for pid in list(self._fds):
            self._drop_stream(pid)
        self._lib.dbeel_qf_free(self._handle)
        self._handle = None


def create_quorum_fanout(my_shard) -> Optional[QuorumFanout]:
    if os.environ.get("DBEEL_NO_QF", "0") not in ("", "0"):
        return None
    try:
        from ..storage import native as native_mod

        lib = native_mod.load_if_built()
        if lib is None:
            return None
        return QuorumFanout(lib, my_shard)
    except Exception:
        log.exception("quorum fanout engine unavailable")
        return None
