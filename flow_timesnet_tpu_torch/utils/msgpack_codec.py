"""A MessagePack encoder and decoder with flax's array extension, in the
standard library and numpy.

It writes the bytes ``flax.serialization.msgpack_serialize`` writes for a
tree of dicts, lists, strings, numbers and numpy arrays: every map's keys
in sorted order (as a JAX pytree holds them), each integer in its shortest
form, Python floats as float64, strings as str8/16/32 and raw bytes as
bin (``use_bin_type``), a numpy array as extension type 1 whose payload is
the packed ``(shape, dtype name, C-order bytes)`` and a numpy scalar as
extension type 3 of the same payload. :func:`unpackb` reads those bytes
back, arrays as numpy arrays (writable copies), and flax's chunked form of
very large arrays.
"""

from __future__ import annotations

import struct
from typing import Any, List, Tuple

import numpy as np

EXT_NDARRAY, EXT_NPSCALAR = 1, 3


def _int(v: int, out: List[bytes]) -> None:
    if 0 <= v < 0x80:
        out.append(struct.pack("B", v))
    elif -32 <= v < 0:
        out.append(struct.pack("b", v))
    elif v >= 0:
        for code, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                               (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < top:
                out.append(struct.pack("B", code) + struct.pack(fmt, v))
                return
        raise OverflowError(f"integer {v} is too large for MessagePack")
    else:
        for code, fmt, low in ((0xD0, ">b", -(1 << 7)), (0xD1, ">h", -(1 << 15)),
                               (0xD2, ">i", -(1 << 31)), (0xD3, ">q", -(1 << 63))):
            if v >= low:
                out.append(struct.pack("B", code) + struct.pack(fmt, v))
                return
        raise OverflowError(f"integer {v} is too small for MessagePack")


def _sized(n: int, fixed: Tuple[int, int], codes: Tuple[int, int, int], out: List[bytes],
           eight: bool = True) -> None:
    """A header for a container or a string of ``n`` elements or bytes."""

    base, limit = fixed
    if n < limit:
        out.append(struct.pack("B", base | n))
    elif eight and n < (1 << 8) and codes[0]:
        out.append(struct.pack(">BB", codes[0], n))
    elif n < (1 << 16):
        out.append(struct.pack(">BH", codes[1], n))
    else:
        out.append(struct.pack(">BI", codes[2], n))


def _ext(code: int, data: bytes, out: List[bytes]) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    n = len(data)
    if n in fixed:
        out.append(struct.pack(">Bb", fixed[n], code))
    elif n < (1 << 8):
        out.append(struct.pack(">BBb", 0xC7, n, code))
    elif n < (1 << 16):
        out.append(struct.pack(">BHb", 0xC8, n, code))
    else:
        out.append(struct.pack(">BIb", 0xC9, n, code))
    out.append(data)


def _array_payload(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured arrays cannot be written")
    return packb((list(arr.shape), arr.dtype.name, np.ascontiguousarray(arr).tobytes("C")))


def _pack(v: Any, out: List[bytes]) -> None:
    if v is None:
        out.append(b"\xc0")
    elif v is True:
        out.append(b"\xc3")
    elif v is False:
        out.append(b"\xc2")
    elif type(v) is int:
        _int(v, out)
    elif type(v) is float:
        out.append(b"\xcb" + struct.pack(">d", v))
    elif type(v) is str:
        data = v.encode("utf-8")
        _sized(len(data), (0xA0, 32), (0xD9, 0xDA, 0xDB), out)
        out.append(data)
    elif type(v) in (bytes, bytearray, memoryview):
        data = bytes(v)
        if len(data) < (1 << 8):
            out.append(struct.pack(">BB", 0xC4, len(data)))
        elif len(data) < (1 << 16):
            out.append(struct.pack(">BH", 0xC5, len(data)))
        else:
            out.append(struct.pack(">BI", 0xC6, len(data)))
        out.append(data)
    elif type(v) in (list, tuple):
        _sized(len(v), (0x90, 16), (0, 0xDC, 0xDD), out, eight=False)
        for x in v:
            _pack(x, out)
    elif type(v) is dict:
        _sized(len(v), (0x80, 16), (0, 0xDE, 0xDF), out, eight=False)
        for k in sorted(v):
            _pack(k, out)
            _pack(v[k], out)
    elif isinstance(v, np.ndarray):
        _ext(EXT_NDARRAY, _array_payload(v), out)
    elif isinstance(v, np.generic):
        _ext(EXT_NPSCALAR, _array_payload(np.asarray(v)), out)
    else:
        raise TypeError(f"cannot write a {type(v).__name__} as MessagePack")


def packb(obj: Any) -> bytes:
    """``obj`` as MessagePack bytes (see the module's doc)."""

    out: List[bytes] = []
    _pack(obj, out)
    return b"".join(out)


class _Reader:
    def __init__(self, data: bytes, raw: bool = False) -> None:
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated MessagePack data")
        chunk = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return chunk

    def unpack(self, fmt: str) -> Any:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def text(self, n: int) -> Any:
        data = self.take(n)
        return data if self.raw else data.decode("utf-8")

    def ext(self, code: int, n: int) -> Any:
        data = self.take(n)
        if code in (EXT_NDARRAY, EXT_NPSCALAR):
            shape, dtype_name, buffer = _Reader(data, raw=True).value()
            name = dtype_name.decode() if isinstance(dtype_name, bytes) else dtype_name
            arr = np.frombuffer(buffer, dtype=np.dtype(name)).reshape(shape).copy()
            return arr if code == EXT_NDARRAY else arr[()]
        raise ValueError(f"unknown MessagePack extension type {code}")

    def value(self) -> Any:
        b = self.unpack("B")
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.text(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
        if b in ints:
            v = self.unpack(ints[b])
            return float(v) if b in (0xCA, 0xCB) else int(v)
        if b in (0xD9, 0xDA, 0xDB):
            return self.text(self.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b]))
        if b in (0xC4, 0xC5, 0xC6):
            return self.take(self.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b]))
        if b in (0xDC, 0xDD):
            return [self.value() for _ in range(self.unpack(">H" if b == 0xDC else ">I"))]
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        if 0xD4 <= b <= 0xD8:
            code = self.unpack(">b")
            return self.ext(code, 1 << (b - 0xD4))
        if b in (0xC7, 0xC8, 0xC9):
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            return self.ext(self.unpack(">b"), n)
        raise ValueError(f"unknown MessagePack type byte 0x{b:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


def _unchunk(tree: Any) -> Any:
    """flax's chunked form of an array larger than 1 GiB, as one array."""

    if isinstance(tree, dict):
        if tree.get("__msgpack_chunked_array__"):
            shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def unpackb(data: bytes) -> Any:
    """MessagePack bytes (as :func:`packb` or flax writes them) as a tree."""

    reader = _Reader(data)
    value = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after a MessagePack value")
    return _unchunk(value)
