"""The MessagePack subset that flax's ``serialization.to_bytes`` writes for a
variables tree, read and written in pure Python (no ``msgpack`` and no flax:
neither is installed where the port runs).

Layout (flax ``serialization``): nested string-keyed maps; each array leaf is
MessagePack ext type 1 (``ndarray``) whose payload is itself MessagePack of
``(shape, dtype name, raw C-order bytes)``; a numpy scalar is ext type 3
with the same payload.  Python scalars, strings, bytes, lists and ``None``
take their plain MessagePack forms.

Not covered, and refused with a clear message: flax's chunked encoding of
leaves above 2**30 bytes (a ``__msgpack_chunked_array__`` map), and complex
values (ext type 2, or a complex array).  A ``bfloat16`` leaf decodes to
float32 (exact; numpy has no bfloat16).
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

NDARRAY_EXT, COMPLEX_EXT, NPSCALAR_EXT = 1, 2, 3
MAX_LEAF_BYTES = 2 ** 30  # flax chunks leaves above this
_CHUNKED = "__msgpack_chunked_array__"


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------


def _length(out: bytearray, n: int, fix_base: int, fix_max: int, codes) -> None:
    """A fix-form header when n fits, else the 8/16/32-bit form (``codes``
    holds the three codes; None where the form does not exist)."""
    if n <= fix_max:
        out.append(fix_base | n)
    elif codes[0] is not None and n <= 0xFF:
        out += bytes((codes[0], n))
    elif n <= 0xFFFF:
        out.append(codes[1])
        out += struct.pack(">H", n)
    else:
        out.append(codes[2])
        out += struct.pack(">I", n)


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v <= 0x7F or -32 <= v < 0:
        out += struct.pack("b" if v < 0 else "B", v)
    elif v >= 0:
        for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                               (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", 2 ** 64 - 1)):
            if v <= top:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"integer {v} does not fit MessagePack")
    else:
        for code, fmt, low in ((0xD0, ">b", -2 ** 7), (0xD1, ">h", -2 ** 15),
                               (0xD2, ">i", -2 ** 31), (0xD3, ">q", -2 ** 63)):
            if v >= low:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"integer {v} does not fit MessagePack")


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    n = len(data)
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixext:
        out.append(fixext[n])
    elif n <= 0xFF:
        out += bytes((0xC7, n))
    elif n <= 0xFFFF:
        out.append(0xC8)
        out += struct.pack(">H", n)
    else:
        out.append(0xC9)
        out += struct.pack(">I", n)
    out += struct.pack("b", code)
    out += data


def _array_payload(arr: np.ndarray) -> bytes:
    if arr.dtype.kind == "c":
        raise NotImplementedError("complex arrays are outside the DAE1 subset")
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialized")
    if arr.nbytes > MAX_LEAF_BYTES:
        raise NotImplementedError(
            f"a leaf of {arr.nbytes} bytes needs flax's chunked encoding (above "
            f"{MAX_LEAF_BYTES} bytes), which this codec does not write")
    return packb((tuple(int(d) for d in arr.shape), arr.dtype.name, arr.tobytes("C")))


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, np.ndarray):
        _pack_ext(out, NDARRAY_EXT, _array_payload(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, NPSCALAR_EXT, _array_payload(np.asarray(obj)))
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, complex):
        raise NotImplementedError("complex values are outside the DAE1 subset")
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _length(out, len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _length(out, len(data), 0, -1, (0xC4, 0xC5, 0xC6))
        out += data
    elif isinstance(obj, (list, tuple)):
        _length(out, len(obj), 0x90, 15, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _length(out, len(obj), 0x80, 15, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__} in a DAE1 payload")


def packb(obj: Any) -> bytes:
    """MessagePack bytes of ``obj`` (maps, lists and tuples, str, bytes,
    int, float, bool, None, numpy arrays and scalars) as flax writes them."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------


def _array_from_payload(data: memoryview) -> np.ndarray:
    (shape, name, buf), _ = _unpack(data, 0)
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        bits = np.frombuffer(buf, dtype="<u2").astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    dtype = np.dtype(name)
    if dtype.kind == "c":
        raise NotImplementedError("complex arrays are outside the DAE1 subset")
    return np.frombuffer(buf, dtype=dtype).reshape(shape).copy()


def _ext(data: memoryview, pos: int, n: int) -> Tuple[Any, int]:
    code = struct.unpack_from("b", data, pos)[0]
    payload = data[pos + 1 : pos + 1 + n]
    end = pos + 1 + n
    if code == NDARRAY_EXT:
        return _array_from_payload(payload), end
    if code == NPSCALAR_EXT:
        return _array_from_payload(payload)[()], end
    if code == COMPLEX_EXT:
        raise NotImplementedError("complex values are outside the DAE1 subset")
    raise ValueError(f"unknown MessagePack ext type {code}")


def _sized(data: memoryview, pos: int, fmt: str) -> Tuple[int, int]:
    return struct.unpack_from(fmt, data, pos)[0], pos + struct.calcsize(fmt)


def _container(data: memoryview, pos: int, n: int, is_map: bool) -> Tuple[Any, int]:
    if not is_map:
        items = []
        for _ in range(n):
            v, pos = _unpack(data, pos)
            items.append(v)
        return items, pos
    out = {}
    for _ in range(n):
        k, pos = _unpack(data, pos)
        v, pos = _unpack(data, pos)
        out[k] = v
    if _CHUNKED in out:
        raise NotImplementedError(
            "this payload holds a leaf in flax's chunked encoding (a leaf above "
            f"{MAX_LEAF_BYTES} bytes), which this codec does not read")
    return out, pos


_FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
          0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
_LEN = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I", 0xC4: ">B", 0xC5: ">H", 0xC6: ">I",
        0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I", 0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


def _unpack(data: memoryview, pos: int) -> Tuple[Any, int]:
    b = data[pos]
    pos += 1
    if b <= 0x7F:
        return b, pos
    if b >= 0xE0:
        return b - 0x100, pos
    if 0x80 <= b <= 0x8F:
        return _container(data, pos, b & 0x0F, True)
    if 0x90 <= b <= 0x9F:
        return _container(data, pos, b & 0x0F, False)
    if 0xA0 <= b <= 0xBF:
        n = b & 0x1F
        return str(data[pos : pos + n], "utf-8"), pos + n
    if b == 0xC0:
        return None, pos
    if b in (0xC2, 0xC3):
        return b == 0xC3, pos
    if b in _FIXED:
        return _sized(data, pos, _FIXED[b])
    if b in _FIXEXT:
        return _ext(data, pos, _FIXEXT[b])
    if b in _LEN:
        n, pos = _sized(data, pos, _LEN[b])
        if b in (0xD9, 0xDA, 0xDB):
            return str(data[pos : pos + n], "utf-8"), pos + n
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(data[pos : pos + n]), pos + n
        if b in (0xDC, 0xDD):
            return _container(data, pos, n, False)
        if b in (0xDE, 0xDF):
            return _container(data, pos, n, True)
        return _ext(data, pos, n)
    raise ValueError(f"MessagePack byte 0x{b:02x} at {pos - 1} is outside the DAE1 subset")


def unpackb(data: bytes) -> Any:
    """The object that :func:`packb` (or flax's ``to_bytes``) wrote; array
    leaves come back as writable numpy arrays."""
    view = memoryview(data)
    obj, pos = _unpack(view, 0)
    if pos != len(view):
        raise ValueError(f"{len(view) - pos} trailing bytes after the MessagePack object")
    return obj
