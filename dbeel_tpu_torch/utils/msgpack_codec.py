"""MessagePack codec with no package behind it.

``packb(obj)`` is byte-identical to ``msgpack.packb(obj,
use_bin_type=True)`` and ``unpackb(buf)`` returns what
``msgpack.unpackb(buf, raw=False)`` returns, raising (a ``ValueError``
or a subclass) where it raises.  The rules that matter to the storage
engine, which decodes every value document of a filtered scan and
keys its mask cache by a packed predicate tree:

* ``bool`` is tested before ``int``; ints take the smallest form,
  unsigned for non-negative values, and one outside [-2^63, 2^64)
  raises ``OverflowError``;
* a Python float always packs as float64; a float32 decodes to a
  Python float;
* ``str`` packs as str (str8 included), bytes-likes as bin; a str
  that is not valid UTF-8 raises on decode, as a lone surrogate does
  on encode;
* map keys must decode to ``str`` or ``bytes`` (msgpack >= 1.0's
  ``strict_map_key=True``): ``{1: 2}`` packs but does not unpack;
* bytes after the first object raise ``ExtraData``;
* ext types decode to an opaque ``ExtType`` (codes 0-127; a negative
  code other than -1 raises), ext -1 to an opaque ``Timestamp`` —
  never to a scalar;
* containers nest at most ``MAX_DEPTH`` deep, like msgpack's stack.
"""

from __future__ import annotations

import struct
from collections import namedtuple
from typing import Any, Tuple

MAX_DEPTH = 1023

_B = struct.Struct(">B")
_H = struct.Struct(">H")
_I = struct.Struct(">I")
_Q = struct.Struct(">Q")
_b = struct.Struct(">b")
_h = struct.Struct(">h")
_i = struct.Struct(">i")
_q = struct.Struct(">q")
_f = struct.Struct(">f")
_d = struct.Struct(">d")


class ExtraData(ValueError):
    """Bytes remain after the first object."""


class ExtType(namedtuple("ExtType", "code data")):
    """An application ext type: ``code`` in 0..127, ``data`` bytes."""

    def __new__(cls, code: int, data: bytes):
        if not isinstance(code, int):
            raise TypeError("code must be int")
        if not isinstance(data, bytes):
            raise TypeError("data must be bytes")
        if not 0 <= code <= 127:
            raise ValueError("code must be 0~127")
        return super().__new__(cls, code, data)


class Timestamp:
    """The timestamp ext (-1), kept opaque: seconds and nanoseconds."""

    __slots__ = ("seconds", "nanoseconds")

    def __init__(self, seconds: int, nanoseconds: int = 0) -> None:
        if not 0 <= nanoseconds < 10**9:
            raise ValueError(
                "nanoseconds must be a non-negative integer less than "
                "999999999."
            )
        self.seconds = seconds
        self.nanoseconds = nanoseconds

    def __eq__(self, other: Any) -> bool:
        return (
            type(other) is Timestamp
            and self.seconds == other.seconds
            and self.nanoseconds == other.nanoseconds
        )

    def __hash__(self) -> int:
        return hash((self.seconds, self.nanoseconds))

    def __repr__(self) -> str:
        return (
            f"Timestamp(seconds={self.seconds}, "
            f"nanoseconds={self.nanoseconds})"
        )

    @staticmethod
    def from_bytes(b: bytes) -> "Timestamp":
        if len(b) == 4:
            return Timestamp(_I.unpack(b)[0], 0)
        if len(b) == 8:
            d = _Q.unpack(b)[0]
            return Timestamp(d & 0x3FFFFFFFF, d >> 34)
        if len(b) == 12:
            ns, sec = struct.unpack(">Iq", b)
            return Timestamp(sec, ns)
        raise ValueError("Timestamp type can only be created from 32, 64, "
                         "or 96-bit byte objects")


# ----------------------------------------------------------------------
# Packing
# ----------------------------------------------------------------------


def packb(obj: Any) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _len_head(out: bytearray, n: int, fix_base: int, fix_max: int,
              op8: int, op16: int, op32: int) -> None:
    if n <= fix_max:
        out.append(fix_base | n)
    elif op8 and n <= 0xFF:
        out.append(op8)
        out.append(n)
    elif n <= 0xFFFF:
        out.append(op16)
        out += _H.pack(n)
    elif n <= 0xFFFFFFFF:
        out.append(op32)
        out += _I.pack(n)
    else:
        raise ValueError("object too large for MessagePack")


def _pack_int(x: int, out: bytearray) -> None:
    if x >= 0:
        if x <= 0x7F:
            out.append(x)
        elif x <= 0xFF:
            out.append(0xCC)
            out.append(x)
        elif x <= 0xFFFF:
            out.append(0xCD)
            out += _H.pack(x)
        elif x <= 0xFFFFFFFF:
            out.append(0xCE)
            out += _I.pack(x)
        elif x <= 0xFFFFFFFFFFFFFFFF:
            out.append(0xCF)
            out += _Q.pack(x)
        else:
            raise OverflowError("Integer value out of range")
    elif x >= -32:
        out.append(x & 0xFF)
    elif x >= -0x80:
        out.append(0xD0)
        out += _b.pack(x)
    elif x >= -0x8000:
        out.append(0xD1)
        out += _h.pack(x)
    elif x >= -0x80000000:
        out.append(0xD2)
        out += _i.pack(x)
    elif x >= -0x8000000000000000:
        out.append(0xD3)
        out += _q.pack(x)
    else:
        raise OverflowError("Integer value out of range")


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += _d.pack(obj)
    elif isinstance(obj, (bytes, bytearray)):
        _len_head(out, len(obj), 0, -1, 0xC4, 0xC5, 0xC6)
        out += obj
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _len_head(out, len(raw), 0xA0, 31, 0xD9, 0xDA, 0xDB)
        out += raw
    elif isinstance(obj, dict):
        _len_head(out, len(obj), 0x80, 15, 0, 0xDE, 0xDF)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, ExtType):
        _pack_ext(obj.code, obj.data, out)
    elif isinstance(obj, (list, tuple)):
        _len_head(out, len(obj), 0x90, 15, 0, 0xDC, 0xDD)
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, memoryview):
        raw = obj.tobytes()
        _len_head(out, len(raw), 0, -1, 0xC4, 0xC5, 0xC6)
        out += raw
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


def _pack_ext(code: int, data: bytes, out: bytearray) -> None:
    n = len(data)
    if n in _FIXEXT:
        out.append(_FIXEXT[n])
    else:
        _len_head(out, n, 0, -1, 0xC7, 0xC8, 0xC9)
    out.append(code & 0xFF)
    out += data


# ----------------------------------------------------------------------
# Unpacking: one loop over the buffer with an explicit container stack
# ----------------------------------------------------------------------

_NO_KEY = object()
# opcode -> (kind, width of the length or value field)
_SIZED = {
    0xC4: ("bin", 1), 0xC5: ("bin", 2), 0xC6: ("bin", 4),
    0xC7: ("ext", 1), 0xC8: ("ext", 2), 0xC9: ("ext", 4),
    0xD9: ("str", 1), 0xDA: ("str", 2), 0xDB: ("str", 4),
    0xDC: ("arr", 2), 0xDD: ("arr", 4),
    0xDE: ("map", 2), 0xDF: ("map", 4),
}
_FIXED = {
    0xCA: _f, 0xCB: _d,
    0xCC: _B, 0xCD: _H, 0xCE: _I, 0xCF: _Q,
    0xD0: _b, 0xD1: _h, 0xD2: _i, 0xD3: _q,
}
_FIXEXT_LEN = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_LEN = {1: _B, 2: _H, 4: _I}


def _incomplete() -> ValueError:
    return ValueError("Unpack failed: incomplete input")


def unpackb(data: Any) -> Any:
    """Decode exactly one object from a bytes-like ``data``."""
    buf = bytes(memoryview(data))
    obj, pos = _decode(buf)
    if pos != len(buf):
        raise ExtraData("unpack(b) received extra data.")
    return obj


def _ext(code: int, body: bytes) -> Any:
    if code == 0xFF:  # -1
        return Timestamp.from_bytes(body)
    if code >= 0x80:
        raise ValueError("code must be 0~127")
    return ExtType(code, body)


def _decode(buf: bytes) -> Tuple[Any, int]:
    n = len(buf)
    pos = 0
    # Open containers: [container, items left, pending map key]
    stack: list = []
    while True:
        if pos >= n:
            raise _incomplete()
        b = buf[pos]
        pos += 1
        size = -1
        if b <= 0x7F:
            obj = b
        elif b >= 0xE0:
            obj = b - 0x100
        elif b <= 0x8F:
            size, obj = b & 0x0F, {}
        elif b <= 0x9F:
            size, obj = b & 0x0F, []
        elif b <= 0xBF:
            end = pos + (b & 0x1F)
            if end > n:
                raise _incomplete()
            obj = buf[pos:end].decode("utf-8")
            pos = end
        elif b == 0xC0:
            obj = None
        elif b == 0xC2:
            obj = False
        elif b == 0xC3:
            obj = True
        elif b in _FIXED:
            st = _FIXED[b]
            end = pos + st.size
            if end > n:
                raise _incomplete()
            obj = st.unpack_from(buf, pos)[0]
            pos = end
        elif b in _FIXEXT_LEN:
            end = pos + 1 + _FIXEXT_LEN[b]
            if end > n:
                raise _incomplete()
            obj = _ext(buf[pos], buf[pos + 1:end])
            pos = end
        elif b in _SIZED:
            kind, width = _SIZED[b]
            if pos + width > n:
                raise _incomplete()
            length = _LEN[width].unpack_from(buf, pos)[0]
            pos += width
            if kind == "arr":
                size, obj = length, []
            elif kind == "map":
                size, obj = length, {}
            else:
                if kind == "ext":
                    if pos >= n:
                        raise _incomplete()
                    code = buf[pos]
                    pos += 1
                end = pos + length
                if end > n:
                    raise _incomplete()
                raw = buf[pos:end]
                pos = end
                if kind == "str":
                    obj = raw.decode("utf-8")
                elif kind == "bin":
                    obj = raw
                else:
                    obj = _ext(code, raw)
        else:  # 0xC1, never used
            raise ValueError(f"Unpack failed: invalid type 0x{b:02x}")
        if size > 0:
            if len(stack) >= MAX_DEPTH:
                raise ValueError("Unpack failed: nesting too deep")
            stack.append([obj, size, _NO_KEY])
            continue
        # ``obj`` is complete: hand it to the open containers.
        while stack:
            top = stack[-1]
            cont = top[0]
            if type(cont) is list:
                cont.append(obj)
            elif top[2] is _NO_KEY:
                if type(obj) is not str and type(obj) is not bytes:
                    raise ValueError(
                        f"{type(obj).__name__} is not allowed for map "
                        "key when strict_map_key=True"
                    )
                top[2] = obj
                break
            else:
                cont[top[2]] = obj
                top[2] = _NO_KEY
            top[1] -= 1
            if top[1]:
                break
            stack.pop()
            obj = cont
        else:
            return obj, pos
