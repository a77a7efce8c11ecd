"""The public document API server — msgpack over TCP (partial).

Wire-compatible with the reference's db_server.rs: one listener per
shard at ``port + shard_id``; requests are u16-LE length-prefixed
msgpack maps; responses are u32-LE length-prefixed payloads with one
trailing type byte (Err=0, Ok=1, Bytes=2); errors cross as
``[name, message]``.

This module holds, for now, only what ``MyShard`` calls: the response
envelope (``_frame_response``), the error envelope
(``_error_response``) and the native plane's pre-packed overload
answers (``install_native_overload_responses``).  The listener, the
request dispatcher and the coordinator paths come with the rest of
the server (one node serving).
"""

from __future__ import annotations

import logging
import struct

from ..errors import DbeelError, KeyNotFound, Overloaded
from ..utils import msgpack_codec

log = logging.getLogger(__name__)

RESPONSE_ERR = 0
RESPONSE_OK = 1
RESPONSE_BYTES = 2


def _frame_response(buf: bytes) -> bytes:
    """Wire envelope: u32-LE length + payload (incl. type byte)."""
    return struct.pack("<I", len(buf)) + buf


def install_native_overload_responses(my_shard) -> None:
    """Arm the native hard-overload/deadline answers (all-native
    serving path): the C client plane returns these COMPLETE wire
    frames for shed and dead-on-arrival data verbs, so a flood being
    shed never touches the interpreter it is flooding.  Packed here
    with the same encoder and message text as the interpreted shed
    path and the dispatcher's deadline drop, so the two paths answer
    byte-identically."""
    dp = my_shard.dataplane
    if dp is None:
        return

    def pack(msg: str) -> bytes:
        e = Overloaded(msg)
        return _frame_response(
            msgpack_codec.packb(e.to_wire()) + bytes([RESPONSE_ERR])
        )

    dp.set_overload_responses(
        pack(f"shard {my_shard.shard_name} shedding load"),
        pack("client deadline expired before dispatch"),
    )


def _error_response(e: Exception) -> bytes:
    """The error wire envelope, shared by the slow path and the
    coordinator fast path so the two can never diverge.  Must be
    called from an except block (log.exception)."""
    if isinstance(e, DbeelError):
        if not isinstance(e, KeyNotFound):
            log.error("error handling request: %r", e)
        return msgpack_codec.packb(e.to_wire()) + bytes([RESPONSE_ERR])
    log.exception("unexpected error handling request")
    return msgpack_codec.packb(["Internal", str(e)]) + bytes(
        [RESPONSE_ERR]
    )
