"""The msgpack subset of flax's checkpoint files, without the ``msgpack``
package.

``flax.serialization.to_bytes`` writes a state dict (nested maps with str
keys) whose leaves are numpy arrays, numpy scalars or Python scalars. This
module reads and writes that subset:

* nil, bool, int, float (float32 read, float64 written), str, bin, array,
  and maps with str keys, in the encodings msgpack-python's packer picks
  (the shortest), so a decoded file encodes back to the same bytes;
* ext type 1, an ``np.ndarray`` packed as the msgpack array
  ``(shape, dtype.name, raw C-order bytes)``;
* ext type 3, a numpy scalar in the same form.

Arrays are written and read whole (``tobytes`` / ``np.frombuffer``); the
arrays :func:`unpack` returns are read-only views into the input buffer.
Maps keep their key order. flax's chunked form for arrays above 2**30 bytes
(``__msgpack_chunked_array__``) is refused both ways: no checkpoint of this
package comes near it.
"""

from __future__ import annotations

import struct

import numpy as np

EXT_NDARRAY, EXT_NPSCALAR = 1, 3
MAX_ARRAY_BYTES = 2 ** 30          # flax chunks arrays above this size
_CHUNKED = "__msgpack_chunked_array__"


class MsgpackError(ValueError):
    """Bytes or objects outside the subset this codec handles."""


# -- encoding ---------------------------------------------------------------

def _pack_int(n: int, out: list) -> None:
    if 0 <= n < 0x80:
        out.append(struct.pack("B", n))
    elif -0x20 <= n < 0:
        out.append(struct.pack("b", n))
    elif n >= 0:
        for code, fmt, top in ((0xcc, ">B", 0xff), (0xcd, ">H", 0xffff),
                               (0xce, ">I", 0xffffffff),
                               (0xcf, ">Q", 0xffffffffffffffff)):
            if n <= top:
                out.append(struct.pack(">B", code) + struct.pack(fmt, n))
                return
        raise MsgpackError(f"integer {n} does not fit 64 bits")
    else:
        for code, fmt, low in ((0xd0, ">b", -0x80), (0xd1, ">h", -0x8000),
                               (0xd2, ">i", -0x80000000),
                               (0xd3, ">q", -0x8000000000000000)):
            if n >= low:
                out.append(struct.pack(">B", code) + struct.pack(fmt, n))
                return
        raise MsgpackError(f"integer {n} does not fit 64 bits")


def _pack_header(n: int, fix: int | None, fix_max: int, codes, out) -> None:
    """A length header: the fix form below ``fix_max``, else the first of
    ``codes`` ((code, struct format, largest length)) that holds ``n``."""
    if fix is not None and n < fix_max:
        out.append(struct.pack("B", fix | n))
        return
    for code, fmt, top in codes:
        if n <= top:
            out.append(struct.pack(">B", code) + struct.pack(fmt, n))
            return
    raise MsgpackError(f"length {n} is too long for msgpack")


_STR = ((0xd9, ">B", 0xff), (0xda, ">H", 0xffff), (0xdb, ">I", 0xffffffff))
_BIN = ((0xc4, ">B", 0xff), (0xc5, ">H", 0xffff), (0xc6, ">I", 0xffffffff))
_ARRAY = ((0xdc, ">H", 0xffff), (0xdd, ">I", 0xffffffff))
_MAP = ((0xde, ">H", 0xffff), (0xdf, ">I", 0xffffffff))
_FIXEXT = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
_EXT = ((0xc7, ">B", 0xff), (0xc8, ">H", 0xffff), (0xc9, ">I", 0xffffffff))


def _pack_array_payload(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.fields is not None:
        raise MsgpackError(f"dtype {arr.dtype} cannot be serialized")
    if arr.nbytes > MAX_ARRAY_BYTES:
        raise MsgpackError(
            f"array of {arr.nbytes} bytes: flax writes arrays above 2**30 "
            "bytes in its chunked form, which this codec does not handle")
    out: list = []
    _pack([list(arr.shape), arr.dtype.name, arr.tobytes("C")], out)
    return b"".join(out)


def _pack_ext(code: int, data: bytes, out: list) -> None:
    if len(data) in _FIXEXT:
        out.append(struct.pack("BB", _FIXEXT[len(data)], code))
    else:
        _pack_header(len(data), None, 0, _EXT, out)
        out.append(struct.pack("B", code))
    out.append(data)


def _pack(obj, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif type(obj) is int:
        _pack_int(obj, out)
    elif type(obj) is float:
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif type(obj) is str:
        raw = obj.encode("utf-8")
        _pack_header(len(raw), 0xa0, 32, _STR, out)
        out.append(raw)
    elif type(obj) is bytes:
        _pack_header(len(obj), None, 0, _BIN, out)
        out.append(obj)
    elif type(obj) is list:
        _pack_header(len(obj), 0x90, 16, _ARRAY, out)
        for x in obj:
            _pack(x, out)
    elif type(obj) is dict:
        _pack_header(len(obj), 0x80, 16, _MAP, out)
        for k, v in obj.items():
            if type(k) is not str:
                raise MsgpackError(f"map key {k!r} is not a str")
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, np.ndarray):
        _pack_ext(EXT_NDARRAY, _pack_array_payload(obj), out)
    elif isinstance(obj, np.generic):
        _pack_ext(EXT_NPSCALAR, _pack_array_payload(np.asarray(obj)), out)
    else:
        raise MsgpackError(f"cannot serialize {type(obj).__name__}")


def pack(tree) -> bytes:
    """Encode a state dict as flax's ``msgpack_serialize`` does."""
    out: list = []
    _pack(tree, out)
    return b"".join(out)


# -- decoding ---------------------------------------------------------------

class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, fmt: str):
        (v,) = struct.unpack_from(fmt, self.buf, self.pos)
        self.pos += struct.calcsize(fmt)
        return v

    def raw(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise MsgpackError("truncated msgpack data")
        v = self.buf[self.pos:self.pos + n]
        self.pos += n
        return v


_SIZED = {0xd9: ("str", ">B"), 0xda: ("str", ">H"), 0xdb: ("str", ">I"),
          0xc4: ("bin", ">B"), 0xc5: ("bin", ">H"), 0xc6: ("bin", ">I"),
          0xdc: ("array", ">H"), 0xdd: ("array", ">I"),
          0xde: ("map", ">H"), 0xdf: ("map", ">I"),
          0xc7: ("ext", ">B"), 0xc8: ("ext", ">H"), 0xc9: ("ext", ">I")}
_SCALARS = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I",
            0xcf: ">Q", 0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
_FIXEXT_LEN = {v: k for k, v in _FIXEXT.items()}


def _unpack_array(payload: memoryview, scalar: bool):
    r = _Reader(payload)
    if r.take("B") != 0x93:
        raise MsgpackError("malformed ndarray extension")
    shape, dtype = _unpack(r), _unpack(r)
    b = r.take("B")
    if (not isinstance(shape, list) or not isinstance(dtype, str)
            or b not in (0xc4, 0xc5, 0xc6)):
        raise MsgpackError("malformed ndarray extension")
    buf = r.raw(r.take(_SIZED[b][1]))     # a view, not a copy
    arr = np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape)
    return arr[()] if scalar else arr


def _unpack(r: _Reader):
    b = r.take("B")
    if b < 0x80:
        return b
    if b >= 0xe0:
        return b - 0x100
    if 0xa0 <= b < 0xc0:
        return str(r.raw(b & 0x1f), "utf-8")
    if 0x90 <= b < 0xa0:
        return [_unpack(r) for _ in range(b & 0x0f)]
    if 0x80 <= b < 0x90:
        return _unpack_map(r, b & 0x0f)
    if b == 0xc0:
        return None
    if b in (0xc2, 0xc3):
        return b == 0xc3
    if b in _SCALARS:
        return r.take(_SCALARS[b])
    if b in _FIXEXT_LEN:
        return _unpack_ext(r, _FIXEXT_LEN[b])
    if b in _SIZED:
        kind, fmt = _SIZED[b]
        n = r.take(fmt)
        if kind == "str":
            return str(r.raw(n), "utf-8")
        if kind == "bin":
            return bytes(r.raw(n))
        if kind == "array":
            return [_unpack(r) for _ in range(n)]
        if kind == "map":
            return _unpack_map(r, n)
        return _unpack_ext(r, n)
    raise MsgpackError(f"unsupported msgpack type byte 0x{b:02x}")


def _unpack_map(r: _Reader, n: int) -> dict:
    d = {}
    for _ in range(n):
        k = _unpack(r)
        if not isinstance(k, str):
            raise MsgpackError(f"map key {k!r} is not a str")
        d[k] = _unpack(r)
    if _CHUNKED in d:
        raise MsgpackError(
            "flax's chunked array form (arrays above 2**30 bytes) is not "
            "supported by this codec")
    return d


def _unpack_ext(r: _Reader, n: int):
    code = r.take("B")
    payload = r.raw(n)
    if code not in (EXT_NDARRAY, EXT_NPSCALAR):
        raise MsgpackError(f"unsupported msgpack extension type {code}")
    return _unpack_array(payload, scalar=code == EXT_NPSCALAR)


def unpack(data: bytes):
    """Decode bytes written by flax's ``msgpack_serialize`` (or
    :func:`pack`) into the same tree ``msgpack_restore`` gives."""
    r = _Reader(data)
    tree = _unpack(r)
    if r.pos != len(r.buf):
        raise MsgpackError(f"{len(r.buf) - r.pos} trailing bytes")
    return tree
