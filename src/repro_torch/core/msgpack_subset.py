"""MessagePack for the subset the migration wire uses.

The wire (``core.migration``) is msgpack, as in the JAX package.  This
module packs and unpacks dict, list (and tuple), str, bytes, int, float,
bool and None, byte for byte as ``msgpack.packb`` / ``msgpack.unpackb``
do at their defaults: ``use_bin_type=True`` (str and bin families kept
apart), the smallest encoding of every int, floats as float64, and on
the way back str keys and bytes values.  Anything else (ext types, sets,
numpy scalars) raises ``TypeError`` rather than guessing.
"""

from __future__ import annotations

import struct

_B = struct.Struct(">B")
_H = struct.Struct(">H")
_I = struct.Struct(">I")
_Q = struct.Struct(">Q")
_b = struct.Struct(">b")
_h = struct.Struct(">h")
_i = struct.Struct(">i")
_q = struct.Struct(">q")
_d = struct.Struct(">d")
_f = struct.Struct(">f")


def _int(v: int, out: list):
    if 0 <= v < 0x80:
        out.append(_B.pack(v))
    elif -0x20 <= v < 0:
        out.append(_b.pack(v))
    elif v > 0:
        if v <= 0xFF:
            out.append(b"\xcc" + _B.pack(v))
        elif v <= 0xFFFF:
            out.append(b"\xcd" + _H.pack(v))
        elif v <= 0xFFFFFFFF:
            out.append(b"\xce" + _I.pack(v))
        elif v <= 0xFFFFFFFFFFFFFFFF:
            out.append(b"\xcf" + _Q.pack(v))
        else:
            raise OverflowError(f"int {v} does not fit msgpack's uint64")
    elif v >= -0x80:
        out.append(b"\xd0" + _b.pack(v))
    elif v >= -0x8000:
        out.append(b"\xd1" + _h.pack(v))
    elif v >= -0x80000000:
        out.append(b"\xd2" + _i.pack(v))
    elif v >= -0x8000000000000000:
        out.append(b"\xd3" + _q.pack(v))
    else:
        raise OverflowError(f"int {v} does not fit msgpack's int64")


def _len(n: int, fix: int, fix_max: int, codes: bytes, out: list,
         has8: bool = True):
    """A length header: fix form, then the 8/16/32-bit forms."""
    if n < fix_max:
        out.append(_B.pack(fix | n))
    elif has8 and n <= 0xFF:
        out.append(codes[0:1] + _B.pack(n))
    elif n <= 0xFFFF:
        out.append(codes[1:2] + _H.pack(n))
    elif n <= 0xFFFFFFFF:
        out.append(codes[2:3] + _I.pack(n))
    else:
        raise ValueError(f"length {n} does not fit msgpack's 32 bits")


def _bin_len(n: int, out: list):
    if n <= 0xFF:
        out.append(b"\xc4" + _B.pack(n))
    elif n <= 0xFFFF:
        out.append(b"\xc5" + _H.pack(n))
    elif n <= 0xFFFFFFFF:
        out.append(b"\xc6" + _I.pack(n))
    else:
        raise ValueError(f"bin of {n} bytes does not fit msgpack's 32 bits")


def _pack(obj, out: list):
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        _int(int(obj), out)
    elif isinstance(obj, float):
        out.append(b"\xcb" + _d.pack(obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _len(len(data), 0xA0, 32, b"\xd9\xda\xdb", out)
        out.append(data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _bin_len(len(data), out)
        out.append(data)
    elif isinstance(obj, (list, tuple)):
        _len(len(obj), 0x90, 16, b"\x00\xdc\xdd", out, has8=False)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _len(len(obj), 0x80, 16, b"\x00\xde\xdf", out, has8=False)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj) -> bytes:
    """``obj`` as msgpack bytes, as ``msgpack.packb(obj)`` gives them."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


class _Reader:
    def __init__(self, data):
        self.mv = memoryview(data)
        self.at = 0

    def take(self, n: int) -> memoryview:
        if self.at + n > len(self.mv):
            raise ValueError("truncated msgpack data")
        part = self.mv[self.at:self.at + n]
        self.at += n
        return part

    def unpack(self, s: struct.Struct):
        return s.unpack(self.take(s.size))[0]


_FIXED = {0xcc: _B, 0xcd: _H, 0xce: _I, 0xcf: _Q,
          0xd0: _b, 0xd1: _h, 0xd2: _i, 0xd3: _q, 0xcb: _d, 0xca: _f}
_STR = {0xd9: _B, 0xda: _H, 0xdb: _I}
_BIN = {0xc4: _B, 0xc5: _H, 0xc6: _I}
_ARRAY = {0xdc: _H, 0xdd: _I}
_MAP = {0xde: _H, 0xdf: _I}


def _read(r: _Reader):
    c = r.unpack(_B)
    if c < 0x80:
        return c
    if c >= 0xE0:
        return c - 0x100
    if 0xA0 <= c < 0xC0:
        return str(r.take(c & 0x1F), "utf-8")
    if 0x90 <= c < 0xA0:
        return [_read(r) for _ in range(c & 0x0F)]
    if 0x80 <= c < 0x90:
        return _map(r, c & 0x0F)
    if c == 0xC0:
        return None
    if c in (0xC2, 0xC3):
        return c == 0xC3
    if c in _FIXED:
        return r.unpack(_FIXED[c])
    if c in _STR:
        return str(r.take(r.unpack(_STR[c])), "utf-8")
    if c in _BIN:
        return bytes(r.take(r.unpack(_BIN[c])))
    if c in _ARRAY:
        return [_read(r) for _ in range(r.unpack(_ARRAY[c]))]
    if c in _MAP:
        return _map(r, r.unpack(_MAP[c]))
    raise ValueError(f"msgpack type byte 0x{c:02x} is outside the subset "
                     "this codec reads")


def _map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        k = _read(r)
        if not isinstance(k, (str, bytes)):
            raise ValueError(f"{type(k).__name__} is not allowed for map "
                             "key")
        out[k] = _read(r)
    return out


def _skip(r: _Reader):
    """Step over one object without building it: str and bin bodies are
    passed by, not copied."""
    c = r.unpack(_B)
    if c < 0x80 or c >= 0xE0 or c in (0xC0, 0xC2, 0xC3):
        return
    if 0xA0 <= c < 0xC0:
        r.take(c & 0x1F)
    elif 0x90 <= c < 0xA0:
        for _ in range(c & 0x0F):
            _skip(r)
    elif 0x80 <= c < 0x90:
        for _ in range(2 * (c & 0x0F)):
            _skip(r)
    elif c in _FIXED:
        r.take(_FIXED[c].size)
    elif c in _STR:
        r.take(r.unpack(_STR[c]))
    elif c in _BIN:
        r.take(r.unpack(_BIN[c]))
    elif c in _ARRAY:
        for _ in range(r.unpack(_ARRAY[c])):
            _skip(r)
    elif c in _MAP:
        for _ in range(2 * r.unpack(_MAP[c])):
            _skip(r)
    else:
        raise ValueError(f"msgpack type byte 0x{c:02x} is outside the "
                         "subset this codec reads")


def unpack_key(data, key: str) -> object:
    """``unpackb(data)[key]`` for data that encodes a map, reading only
    that value: the others are stepped over, so a slot blob's header
    costs its own bytes and not its 100 MB payload's."""
    r = _Reader(data)
    c = r.unpack(_B)
    if 0x80 <= c < 0x90:
        n = c & 0x0F
    elif c in _MAP:
        n = r.unpack(_MAP[c])
    else:
        raise ValueError(f"msgpack type byte 0x{c:02x} is not a map")
    for _ in range(n):
        if _read(r) == key:
            return _read(r)
        _skip(r)
    raise KeyError(key)


def unpackb(data) -> object:
    """The object ``data`` encodes (str keys, bytes values, lists)."""
    r = _Reader(data)
    obj = _read(r)
    if r.at != len(r.mv):
        raise ValueError(f"{len(r.mv) - r.at} extra bytes after the object")
    return obj
