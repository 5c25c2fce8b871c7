"""A first-party msgpack codec for the subset flax checkpoints use.

The JAX package writes checkpoints with ``flax.serialization``
(``msgpack_serialize`` / ``msgpack_restore``). This module reads and
writes the same bytes without the ``msgpack`` package:

- maps, arrays (lists/tuples), str, bin (bytes), nil, bools, ints and
  floats;
- ext type 1: a numpy array, packed as the msgpack array
  ``(shape, dtype name, C-order bytes)`` (flax ``_ndarray_to_bytes``);
- ext type 3: a numpy scalar, the same encoding of a 0-d array;
- flax's chunked form of arrays larger than 1 GiB, on read.

Maps are written with sorted keys, so a tree writes the same bytes as
flax writes for it. :func:`pack_chunks` gives those bytes as a list of
buffers in which every array's data is a view, not a copy, so a large
checkpoint is written to a file without being assembled in memory (and
without holding the GIL for the copies); a :class:`PackedBin` inside the
tree is a nested msgpack object written as one bin (flax's bytes of an
optax state inside a checkpoint).
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------


def _pack_int(v: int, out: List[bytes]) -> None:
    if 0 <= v < 0x80:
        out.append(struct.pack("B", v))
    elif -32 <= v < 0:
        out.append(struct.pack("b", v))
    elif v >= 0:
        for code, fmt, hi in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                              (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < hi:
                out.append(bytes([code]) + struct.pack(fmt, v))
                return
        raise OverflowError(f"int {v} too large for msgpack")
    else:
        for code, fmt, lo in ((0xD0, ">b", -(1 << 7)), (0xD1, ">h", -(1 << 15)),
                              (0xD2, ">i", -(1 << 31)), (0xD3, ">q", -(1 << 63))):
            if v >= lo:
                out.append(bytes([code]) + struct.pack(fmt, v))
                return
        raise OverflowError(f"int {v} too small for msgpack")


def _pack_len(n: int, fix: int, fix_max: int, codes, out: List[bytes]) -> None:
    """Header of a str/bin/array/map of length n (``fix`` None: no fix
    form)."""
    if fix is not None and n <= fix_max:
        out.append(bytes([fix | n]))
        return
    for code, fmt, hi in codes:
        if code is not None and n < hi:
            out.append(bytes([code]) + struct.pack(fmt, n))
            return
    raise OverflowError(f"length {n} too large for msgpack")


_STR = ((0xD9, ">B", 1 << 8), (0xDA, ">H", 1 << 16), (0xDB, ">I", 1 << 32))
_BIN = ((0xC4, ">B", 1 << 8), (0xC5, ">H", 1 << 16), (0xC6, ">I", 1 << 32))
_ARR = ((None, "", 0), (0xDC, ">H", 1 << 16), (0xDD, ">I", 1 << 32))
_MAP = ((None, "", 0), (0xDE, ">H", 1 << 16), (0xDF, ">I", 1 << 32))


def _pack_ext_header(code: int, n: int, out: List[bytes]) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(bytes([fixed[n], code]))
    elif n < 1 << 8:
        out.append(struct.pack(">BBb", 0xC7, n, code))
    elif n < 1 << 16:
        out.append(struct.pack(">BHb", 0xC8, n, code))
    else:
        out.append(struct.pack(">BIb", 0xC9, n, code))


def _pack_ndarray(code: int, arr: np.ndarray, out: List) -> None:
    """An array as the ext ``code`` holding ``(shape, dtype name, C-order
    bytes)``; the bytes are a view of the (contiguous) array."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialized")
    if not arr.flags.c_contiguous:  # (ascontiguousarray would make a 0-d array 1-d)
        arr = np.ascontiguousarray(arr)
    head: List = []
    _pack_len(3, 0x90, 15, _ARR, head)
    _pack(list(arr.shape), head)
    _pack(arr.dtype.name, head)
    _pack_len(arr.nbytes, None, -1, _BIN, head)
    _pack_ext_header(code, sum(len(c) for c in head) + arr.nbytes, out)
    out.extend(head)
    out.append(memoryview(arr.reshape(-1).view(np.uint8)))


class PackedBin:
    """Buffers of :func:`pack_chunks`, packed as one bin of their bytes."""

    def __init__(self, chunks: List):
        self.chunks = chunks
        self.nbytes = sum(len(c) for c in chunks)


def _pack(obj: Any, out: List[bytes]) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, np.ndarray):
        _pack_ndarray(_EXT_NDARRAY, obj, out)
    elif isinstance(obj, np.generic):
        _pack_ndarray(_EXT_NPSCALAR, np.asarray(obj), out)
    elif isinstance(obj, PackedBin):
        _pack_len(obj.nbytes, None, -1, _BIN, out)
        out.extend(obj.chunks)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(len(data), 0xA0, 31, _STR, out)
        out.append(data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _pack_len(len(data), None, -1, _BIN, out)
        out.append(data)
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 15, _ARR, out)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 15, _MAP, out)
        # sorted keys, as flax writes them (its tree_map copy sorts dicts)
        for k in sorted(obj):
            _pack(k, out)
            _pack(obj[k], out)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__}")


def pack_chunks(obj: Any) -> List:
    """:func:`packb`'s bytes as a list of buffers (bytes and memoryviews of
    the arrays in ``obj``, which must not change until they are written)."""
    out: List = []
    _pack(obj, out)
    return out


def packb(obj: Any) -> bytes:
    """Serialize ``obj`` (the types of the module docstring)."""
    return b"".join(pack_chunks(obj))


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


class _Reader:
    def __init__(self, data: bytes, raw_str: bool = False):
        self.buf = memoryview(data)
        self.pos = 0
        self.raw_str = raw_str

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        view = self.buf[self.pos : self.pos + n]
        self.pos += n
        return view

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self) -> Any:
        b = self.take(1)[0]
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.read_map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.read_str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        if b in (0xC4, 0xC5, 0xC6):
            n = self.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b])
            return bytes(self.take(n))
        if b in (0xC7, 0xC8, 0xC9):
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            return self.read_ext(n)
        if b in (0xD4, 0xD5, 0xD6, 0xD7, 0xD8):
            return self.read_ext(1 << (b - 0xD4))
        if b == 0xCA:
            return self.unpack(">f")
        if b == 0xCB:
            return self.unpack(">d")
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in ints:
            return self.unpack(ints[b])
        if b in (0xD9, 0xDA, 0xDB):
            return self.read_str(self.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b]))
        if b in (0xDC, 0xDD):
            n = self.unpack(">H" if b == 0xDC else ">I")
            return [self.read() for _ in range(n)]
        if b in (0xDE, 0xDF):
            return self.read_map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def read_str(self, n: int):
        data = bytes(self.take(n))
        return data if self.raw_str else data.decode("utf-8")

    def read_map(self, n: int) -> Dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def read_ext(self, n: int) -> Any:
        code = struct.unpack("b", self.take(1))[0]
        data = bytes(self.take(n))
        if code == _EXT_NDARRAY:
            return _ndarray_from_bytes(data)
        if code == _EXT_NPSCALAR:
            return _ndarray_from_bytes(data)[()]
        raise ValueError(f"unsupported msgpack ext type {code}")


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    shape, dtype_name, buffer = _Reader(data, raw_str=True).read()
    name = dtype_name.decode() if isinstance(dtype_name, bytes) else dtype_name
    try:
        dtype = np.dtype(name)
    except TypeError:
        raise ValueError(f"array dtype {name!r} is not supported") from None
    return np.frombuffer(buffer, dtype=dtype).reshape(shape, order="C")


def _unchunk(tree: Any) -> Any:
    if not isinstance(tree, dict):
        return tree
    if tree.get(_CHUNKED):
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def unpackb(data: bytes) -> Any:
    """Deserialize bytes written by :func:`packb` or flax's
    ``msgpack_serialize``."""
    reader = _Reader(data)
    obj = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError("trailing bytes after the msgpack object")
    return _unchunk(obj)
