"""ctypes wrapper over the compiled C++ smart client
(native/src/dbeel_client.cpp) — the compiled analog of the reference's
dbeel_client (lib.rs:85-152, 336-417): metadata bootstrap, client-side
ring, replica walk with replica_index, resync-and-retry on
KeyNotOwnedByShard, persistent keepalive connections.

This is also the serving-path latency yardstick: one Python→C call per
operation, everything else (framing, routing, socket IO) compiled.

The client is compiled into the same library as the rest of the native
runtime; ``storage/native.py`` binds its ``dbeel_cli_*`` symbols with
the others (``_PROTOTYPES``), so a library that lacks one is not used
at all.  Keys and values go through this package's own msgpack codec
(``utils/msgpack_codec.py``), byte-identical to ``msgpack``'s.
"""

from __future__ import annotations

import ctypes
from typing import Any, Optional

from ..errors import DbeelError, KeyNotFound
from ..storage import native as native_mod
from ..utils import msgpack_codec

# The get buffer starts small and grows on demand (the C side reports
# the needed size); eager 16MB-per-client buffers measurably crowd the
# page cache when dozens of bench clients colocate with the server.
_GET_BUF_INITIAL = 256 << 10
_GET_BUF_MAX = 64 << 20

# Sentinel: "no expect_value armed" must be distinguishable from an
# expected value of None (a legitimate stored document).
_CAS_NO_EXPECT = object()


def available() -> bool:
    """True exactly when the native library is built and carries every
    symbol of ``storage.native._PROTOTYPES`` (the client's included);
    never runs make."""
    return native_mod.load_if_built() is not None


class NativeDbeelClient:
    """Synchronous compiled client.  Blocking — use from scripts,
    benchmarks, and worker threads (never on a server event loop)."""

    def __init__(self, seed_ip: str, seed_port: int):
        # Raises when native/ cannot be built or lacks a symbol.
        lib = native_mod.require()
        self._lib = lib
        self._h = lib.dbeel_cli_new(
            seed_ip.encode(), ctypes.c_uint16(seed_port)
        )
        if not self._h:
            raise ConnectionError(
                f"could not bootstrap from {seed_ip}:{seed_port}"
            )
        self._buf = None  # allocated lazily by the first get

    def close(self) -> None:
        if self._h:
            self._lib.dbeel_cli_free(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------------

    def _err(self) -> str:
        return self._lib.dbeel_cli_last_error(self._h).decode(
            "utf-8", "replace"
        )

    def _into(self, call, buf, limit: Optional[int] = None):
        """``call(buf, len(buf))``, and once more into a buffer of the
        size the C side reports (``-needed - 10``) when ``buf`` was too
        small; returns the call's result and the buffer it wrote."""
        for _ in range(2):
            n = int(call(buf, len(buf)))
            if n > -10:
                break
            needed = -n - 10
            if limit is not None and needed > limit:
                raise DbeelError(self._err())
            buf = (ctypes.c_uint8 * needed)()
        return n, buf

    def _server_dump(self, fn, ip: str, port: int) -> dict:
        """One server's stats-like answer through ``fn`` (the bootstrap
        seed by default), unpacked."""
        n, buf = self._into(
            lambda b, cap: fn(self._h, ip.encode(), port, b, cap),
            (ctypes.c_uint8 * (1 << 20))(),
        )
        if n < 0:
            raise DbeelError(self._err())
        return msgpack_codec.unpackb(bytes(buf[:n]))

    @property
    def ring_size(self) -> int:
        return int(self._lib.dbeel_cli_ring_size(self._h))

    def sync_metadata(self) -> None:
        if self._lib.dbeel_cli_sync(self._h) != 0:
            raise DbeelError(self._err())

    def set_retry(
        self,
        op_deadline_ms: int = 0,
        backoff_base_ms: int = 0,
        backoff_cap_ms: int = 0,
    ) -> bool:
        """Tune the C walk's failure budget (0 keeps a knob's current
        value: 10 s deadline, 20 ms backoff base, 500 ms cap).
        Returns True, as the reference client's does on a library that
        has the symbol (every library this package loads has it)."""
        self._lib.dbeel_cli_set_retry(
            self._h, op_deadline_ms, backoff_base_ms, backoff_cap_ms
        )
        return True

    def get_stats(
        self, ip: str = "", port: int = 0
    ) -> dict:
        """One server's get_stats snapshot (the bootstrap seed by
        default), unpacked — same schema as the Python client's
        get_stats(), incl. the replica-convergence block."""
        return self._server_dump(self._lib.dbeel_cli_get_stats, ip, port)

    def cluster_stats(self, ip: str = "", port: int = 0) -> dict:
        """One node's gossip-aggregated cluster health view (the
        bootstrap seed by default), unpacked — same schema as the
        Python client's cluster_stats()."""
        return self._server_dump(self._lib.dbeel_cli_cluster_stats, ip, port)

    def set_trace(self, base_trace_id: int) -> bool:
        """Arm per-op trace stamping in the C walk: every single-op
        request carries an auto-incrementing ``trace`` id starting at
        ``base_trace_id`` (0 disarms) — the server serves those
        interpreted and records full per-stage spans.  Returns True,
        as ``set_retry`` does."""
        self._lib.dbeel_cli_set_trace(self._h, base_trace_id)
        return True

    def set_qos(
        self, qos_class: "str | int | None" = None,
        tenant: "str | None" = None,
    ) -> bool:
        """Arm QoS stamping (QoS plane): every data-op
        frame carries the traffic class ("interactive" > "standard" >
        "batch", or the wire int) and/or the tenant id the server's
        per-collection token buckets key by.  ``None, None`` disarms.
        Returns True, as ``set_retry`` does."""
        from ..cluster.messages import qos_class_of

        cls = -1 if qos_class is None else qos_class_of(qos_class)
        self._lib.dbeel_cli_set_qos(
            self._h, cls, (tenant or "").encode()
        )
        return True

    def trace_dump(self, ip: str = "", port: int = 0) -> dict:
        """One server's flight-recorder dump (the bootstrap seed by
        default), unpacked — same schema as the Python client's
        trace_dump()."""
        return self._server_dump(self._lib.dbeel_cli_trace_dump, ip, port)

    def _scan_chunk(
        self,
        collection: str,
        cursor: Optional[bytes],
        count_only: bool,
        prefix: Optional[bytes],
        limit: int,
        max_bytes: int,
        spec: Optional[bytes] = None,
        ip: str = "",
        port: int = 0,
    ) -> dict:
        """One raw scan chunk through the C client (retryable server
        sheds back off and resume — the cursor is client-held).
        ``spec`` is the packed filter/aggregate blob
        (dbeel_tpu_torch.query.pack_spec), forwarded verbatim."""
        cur = (
            (ctypes.c_uint8 * len(cursor)).from_buffer_copy(cursor)
            if cursor
            else None
        )
        pfx = (
            (ctypes.c_uint8 * len(prefix)).from_buffer_copy(prefix)
            if prefix
            else None
        )
        spc = (
            (ctypes.c_uint8 * len(spec)).from_buffer_copy(spec)
            if spec
            else None
        )
        def call(buf, cap):
            return self._lib.dbeel_cli_scan_chunk(
                self._h,
                ip.encode(),
                port,
                collection.encode(),
                cur,
                len(cursor) if cursor else 0,
                1 if count_only else 0,
                pfx,
                len(prefix) if prefix else 0,
                limit,
                max_bytes,
                spc,
                len(spec) if spec else 0,
                buf,
                cap,
            )

        buf = (ctypes.c_uint8 * (1 << 20))()
        backoff = 0.02
        for attempt in range(64):
            n, buf = self._into(call, buf)
            if n == -3 and attempt < 63:
                # Retryable (Overloaded shed / transport): back off
                # with the walk's jittered cap, then resume.
                import random as _random
                import time as _time

                _time.sleep(backoff * (0.5 + 0.5 * _random.random()))
                backoff = min(0.5, backoff * 2)
                continue
            break
        if n < 0:
            raise DbeelError(self._err())
        return msgpack_codec.unpackb(bytes(buf[:n]))

    def scan(
        self,
        collection: str,
        prefix: Optional[bytes] = None,
        limit: int = 0,
        max_bytes: int = 0,
        filter: Optional[Any] = None,
    ) -> list:
        """Full/range streaming scan through the C client: decoded
        (key, value) pairs in encoded-key byte order, chunked and
        cursor-resumed under the hood (same stream semantics as the
        Python client's ``DbeelCollection.scan``).  ``filter`` is a
        predicate tree (dbeel_tpu_torch.query) pushed down to the
        replicas' staged columns — spec pass-through: this client
        packs it once and forwards bytes."""
        spec = None
        if filter is not None:
            from .. import query as _query

            w, _ = _query.build_spec(filter, None)
            spec = _query.pack_spec(w, None)
        out: list = []
        cursor: Optional[bytes] = None
        while True:
            chunk = self._scan_chunk(
                collection, cursor, False, prefix, limit,
                max_bytes, spec,
            )
            # Entries decode with the chunk itself (spliced stored
            # encodings — one unpack per chunk).
            for key, value in chunk.get("entries") or ():
                out.append((key, value))
            cursor = chunk.get("cursor")
            if not cursor:
                return out

    def count(
        self,
        collection: str,
        prefix: Optional[bytes] = None,
        limit: int = 0,
        filter: Optional[Any] = None,
        aggregate: Optional[dict] = None,
    ) -> Any:
        """Live-document count via the keys-only pushdown — no value
        bytes cross any wire.  ``filter`` counts matches only;
        ``aggregate`` returns the pushed-down aggregate result
        instead (the final chunk's "agg" field), mirroring the
        Python client's ``DbeelCollection.count``."""
        spec = None
        count_only = True
        if aggregate is not None:
            from .. import query as _query

            w, a = _query.build_spec(filter, aggregate)
            spec = _query.pack_spec(w, a)
            count_only = False
        elif filter is not None:
            from .. import query as _query

            w, _ = _query.build_spec(filter, None)
            spec = _query.pack_spec(w, None)
        cursor: Optional[bytes] = None
        total = 0
        while True:
            chunk = self._scan_chunk(
                collection, cursor, count_only, prefix, limit, 0,
                spec,
            )
            total = int(chunk.get("count") or 0)
            cursor = chunk.get("cursor")
            if not cursor:
                if aggregate is not None:
                    return chunk.get("agg")
                return total

    def create_collection(
        self,
        name: str,
        replication_factor: int = 1,
        index: Optional[list] = None,
    ) -> None:
        if index:
            csv = ",".join(str(f) for f in index)
            rc = self._lib.dbeel_cli_create_collection_indexed(
                self._h, name.encode(), replication_factor, csv.encode()
            )
        else:
            rc = self._lib.dbeel_cli_create_collection(
                self._h, name.encode(), replication_factor
            )
        if rc != 0:
            raise DbeelError(self._err())

    @staticmethod
    def _enc(obj: Any) -> bytes:
        return msgpack_codec.packb(obj)

    def set(
        self,
        collection: str,
        key: Any,
        value: Any,
        consistency: int = 0,
        rf: int = 1,
    ) -> None:
        k = self._enc(key)
        v = self._enc(value)
        rc = self._lib.dbeel_cli_set(
            self._h,
            collection.encode(),
            (ctypes.c_uint8 * len(k)).from_buffer_copy(k),
            len(k),
            (ctypes.c_uint8 * len(v)).from_buffer_copy(v),
            len(v),
            consistency,
            rf,
        )
        if rc != 0:
            raise DbeelError(self._err())

    def get(
        self,
        collection: str,
        key: Any,
        consistency: int = 0,
        rf: int = 1,
    ) -> Optional[Any]:
        k = self._enc(key)
        kb = (ctypes.c_uint8 * len(k)).from_buffer_copy(k)
        n, self._buf = self._into(
            lambda buf, cap: self._lib.dbeel_cli_get(
                self._h, collection.encode(), kb, len(k), consistency,
                rf, buf, cap,
            ),
            self._get_buf(),
            _GET_BUF_MAX,
        )
        if n == -1:
            raise KeyNotFound(repr(key))
        if n < 0:
            raise DbeelError(self._err())
        return msgpack_codec.unpackb(bytes(self._buf[:n]))

    def _get_buf(self):
        if self._buf is None:
            self._buf = (ctypes.c_uint8 * _GET_BUF_INITIAL)()
        return self._buf

    # -- pipelined mode (windowed in-flight train per connection) ------

    def pipe_set(
        self,
        collection: str,
        key: Any,
        value: Any,
        consistency: int = 0,
        rf: int = 1,
        window: int = 16,
    ) -> None:
        """Enqueue one set on the pipelined train (replica-0 routed);
        at most ``window`` responses ride unread per connection.
        Application errors surface at pipe_drain()."""
        k, v = self._enc(key), self._enc(value)
        rc = self._lib.dbeel_cli_pipe_set(
            self._h,
            collection.encode(),
            (ctypes.c_uint8 * len(k)).from_buffer_copy(k),
            len(k),
            (ctypes.c_uint8 * len(v)).from_buffer_copy(v),
            len(v),
            consistency,
            rf,
            window,
        )
        if rc != 0:
            raise DbeelError(self._err())

    def pipe_get(
        self,
        collection: str,
        key: Any,
        consistency: int = 0,
        rf: int = 1,
        window: int = 16,
    ) -> None:
        """Enqueue one get on the pipelined train (value discarded —
        throughput-path API; correctness checks use get())."""
        k = self._enc(key)
        rc = self._lib.dbeel_cli_pipe_get(
            self._h,
            collection.encode(),
            (ctypes.c_uint8 * len(k)).from_buffer_copy(k),
            len(k),
            consistency,
            rf,
            window,
        )
        if rc != 0:
            raise DbeelError(self._err())

    def pipe_run(
        self,
        collection: str,
        op: str,
        keys,
        values=None,
        consistency: int = 0,
        rf: int = 1,
        window: int = 16,
    ) -> int:
        """Pipeline a whole train of ops in ONE C call (the ctypes
        boundary releases the GIL for the entire train, so worker
        threads overlap fully) and drain it; returns the application
        failure count.  ``op`` is "set" (values required) or "get"."""
        keys = list(keys)
        if not keys:
            return 0
        is_set = op == "set"
        kbuf = bytearray()
        for key in keys:
            k = self._enc(key)
            kbuf += len(k).to_bytes(4, "little") + k
        vbuf = bytearray()
        if is_set:
            for value in values:
                v = self._enc(value)
                vbuf += len(v).to_bytes(4, "little") + v
        rc = int(
            self._lib.dbeel_cli_pipe_run(
                self._h,
                collection.encode(),
                1 if is_set else 0,
                (ctypes.c_uint8 * len(kbuf)).from_buffer(kbuf),
                len(kbuf),
                (ctypes.c_uint8 * len(vbuf)).from_buffer(vbuf)
                if vbuf
                else None,
                len(vbuf),
                len(keys),
                consistency,
                rf,
                window,
            )
        )
        if rc < 0:
            raise DbeelError(self._err())
        return rc

    def pipe_drain(self) -> int:
        """Read every outstanding pipelined response; returns how
        many were application errors (0 on a healthy run)."""
        rc = int(self._lib.dbeel_cli_pipe_drain(self._h))
        if rc < 0:
            raise DbeelError(self._err())
        return rc

    # -- batched multi-ops ---------------------------------------------

    def multi_set(
        self,
        collection: str,
        items,
        consistency: int = 0,
        rf: int = 1,
    ) -> None:
        """Batched set: one multi_set frame per owning node (C-side
        grouping/chunking); sub-ops the batch path could not land
        retry through the single-op walk (full failover)."""
        pairs = (
            list(items.items())
            if isinstance(items, dict)
            else list(items)
        )
        if not pairs:
            return
        buf = bytearray()
        for key, value in pairs:
            k, v = self._enc(key), self._enc(value)
            buf += len(k).to_bytes(4, "little") + k
            buf += len(v).to_bytes(4, "little") + v
        status = (ctypes.c_uint8 * len(pairs))()
        rc = self._lib.dbeel_cli_multi_set(
            self._h,
            collection.encode(),
            (ctypes.c_uint8 * len(buf)).from_buffer(buf),
            len(buf),
            len(pairs),
            consistency,
            rf,
            status,
        )
        if rc < 0:
            raise DbeelError(self._err())
        for i in range(len(pairs)):
            if status[i]:
                self.set(
                    collection, pairs[i][0], pairs[i][1],
                    consistency, rf,
                )

    def multi_get(
        self,
        collection: str,
        keys,
        consistency: int = 0,
        rf: int = 1,
    ) -> list:
        """Batched get: returns values aligned with ``keys`` (None
        for missing); retryable sub-ops fall back to the single-op
        walk."""
        keys = list(keys)
        if not keys:
            return []
        buf = bytearray()
        for key in keys:
            k = self._enc(key)
            buf += len(k).to_bytes(4, "little") + k
        kb = (ctypes.c_uint8 * len(buf)).from_buffer(buf)
        n, self._buf = self._into(
            lambda dst, cap: self._lib.dbeel_cli_multi_get(
                self._h, collection.encode(), kb, len(buf), len(keys),
                consistency, rf, dst, cap,
            ),
            self._get_buf(),
            _GET_BUF_MAX,
        )
        if n < 0:
            raise DbeelError(self._err())
        raw = bytes(self._buf[:n])
        out: list = []
        off = 0
        for i in range(len(keys)):
            st = raw[off]
            vn = int.from_bytes(raw[off + 1 : off + 5], "little")
            payload = raw[off + 5 : off + 5 + vn]
            off += 5 + vn
            if st == 0:
                out.append(msgpack_codec.unpackb(payload))
            elif st == 1:
                out.append(None)
            else:
                try:
                    out.append(
                        self.get(collection, keys[i], consistency, rf)
                    )
                except KeyNotFound:
                    out.append(None)
        return out

    def cas(
        self,
        collection: str,
        key: Any,
        value: Any = None,
        delete: bool = False,
        expect_value: Any = _CAS_NO_EXPECT,
        expect_ts: Optional[int] = None,
        expect_absent: bool = False,
        consistency: int = 0,
        rf: int = 1,
    ) -> bool:
        """Conditional write through the C walk (atomic plane):
        commit ``value`` (or a delete) only if the key's current state
        matches the armed expectation.  Returns True on commit, False
        on a CAS conflict (re-read, then retry with fresh
        expectations); raises on infrastructure errors."""
        k = self._enc(key)
        v = None if delete else self._enc(value)
        ev = (
            None
            if expect_value is _CAS_NO_EXPECT
            else self._enc(expect_value)
        )
        rc = self._lib.dbeel_cli_cas(
            self._h,
            collection.encode(),
            (ctypes.c_uint8 * len(k)).from_buffer_copy(k),
            len(k),
            (ctypes.c_uint8 * len(v)).from_buffer_copy(v)
            if v is not None
            else None,
            len(v) if v is not None else 0,
            1 if delete else 0,
            (ctypes.c_uint8 * len(ev)).from_buffer_copy(ev)
            if ev is not None
            else None,
            len(ev) if ev is not None else 0,
            1 if expect_absent else 0,
            -1 if expect_ts is None else int(expect_ts),
            consistency,
            rf,
        )
        if rc == 0:
            return True
        if rc == -3:
            return False
        raise DbeelError(self._err())

    def delete(
        self,
        collection: str,
        key: Any,
        consistency: int = 0,
        rf: int = 1,
    ) -> None:
        k = self._enc(key)
        rc = self._lib.dbeel_cli_delete(
            self._h,
            collection.encode(),
            (ctypes.c_uint8 * len(k)).from_buffer_copy(k),
            len(k),
            consistency,
            rf,
        )
        if rc != 0:
            raise DbeelError(self._err())
