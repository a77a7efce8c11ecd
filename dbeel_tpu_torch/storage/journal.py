"""Compact-action journal codec.

The journal ``{"renames": [[src, dst], ...], "deletes": [path, ...]}``
is written in MessagePack, byte-identical to
``msgpack.packb(action, use_bin_type=True)`` — which is what dbeel_tpu
writes, so a journal left by either package replays in the other.  The
bytes come from the package's MessagePack codec
(``utils/msgpack_codec``); this module holds the journal to its shape:
maps, arrays and strings only, in both directions.
"""

from __future__ import annotations

from typing import Any

from ..utils import msgpack_codec


def _journal_shaped(obj: Any) -> bool:
    if isinstance(obj, str):
        return True
    if isinstance(obj, (list, tuple)):
        return all(_journal_shaped(x) for x in obj)
    if isinstance(obj, dict):
        return all(
            _journal_shaped(k) and _journal_shaped(v)
            for k, v in obj.items()
        )
    return False


def packb(obj: Any) -> bytes:
    if not _journal_shaped(obj):
        raise TypeError("journal codec packs maps, arrays and strings only")
    return msgpack_codec.packb(obj)


def unpackb(buf: bytes) -> Any:
    """Inverse of packb; raises ValueError on anything else, including
    a torn (truncated) or over-long buffer."""
    obj = msgpack_codec.unpackb(buf)
    if not _journal_shaped(obj):
        raise ValueError("not a compact-action journal")
    return obj
