"""A reader for ``flax.serialization.msgpack_serialize`` files, in pure Python.

The JAX package writes its checkpoints (``models_{step}.msgpack``) with
flax, which packs a state dict with the ``msgpack`` package.  The card's
machine has neither, so the port decodes the format itself:

- every msgpack type flax emits: nil, bool, int (fixint, u/int 8-64), float
  32/64, str, bin, array, map and ext (big-endian throughout); an array
  decodes to a list, a map to a dict;
- flax's ext types: ``ndarray`` = 1 (a msgpack array of shape, dtype name
  and the C-order buffer), ``native_complex`` = 2 (a msgpack array of real
  and imaginary part) and ``npscalar`` = 3 (an ``ndarray`` payload, returned
  as a NumPy scalar); another code decodes to ``ExtType(code, data)``;
- flax's chunked arrays: an array over ``MAX_CHUNK_SIZE`` (2**30) bytes is
  written as a map ``{"__msgpack_chunked_array__": True, "shape": {"0":
  d0, ...}, "chunks": {"0": flat0, ...}}``, which decodes back to the array.

``load`` reads the file once; arrays are ``np.frombuffer`` views of that
buffer, reshaped, with no per-element Python work (a full-width checkpoint
is hundreds of MB).  They are read-only: copy one before writing to it.  A
``bfloat16`` array (which NumPy lacks) decodes to its exact float32 values.
"""

from __future__ import annotations

import struct
from typing import Any, NamedTuple, Tuple

import numpy as np

EXT_NDARRAY, EXT_NATIVE_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"


class ExtType(NamedTuple):
    code: int
    data: bytes


_FIXED = {  # first byte -> (struct format, size) of a fixed-width scalar
    0xca: (">f", 4), 0xcb: (">d", 8),
    0xcc: (">B", 1), 0xcd: (">H", 2), 0xce: (">I", 4), 0xcf: (">Q", 8),
    0xd0: (">b", 1), 0xd1: (">h", 2), 0xd2: (">i", 4), 0xd3: (">q", 8),
}
_LENGTH = {">B": 1, ">H": 2, ">I": 4}
_STR = {0xd9: ">B", 0xda: ">H", 0xdb: ">I"}
_BIN = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I"}
_ARRAY = {0xdc: ">H", 0xdd: ">I"}
_MAP = {0xde: ">H", 0xdf: ">I"}
_EXT = {0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


class _Decoder:
    """``bin`` decodes to ``bytes``, or with ``views`` to a ``memoryview``
    of the buffer (an array's data, which ``np.frombuffer`` then wraps
    without a copy)."""

    def __init__(self, buf: memoryview, views: bool = False):
        self.buf = buf
        self.pos = 0
        self.views = views

    def _take(self, n: int) -> memoryview:
        start = self.pos
        self.pos += n
        if self.pos > len(self.buf):
            raise ValueError(f"truncated msgpack data at byte {start}")
        return self.buf[start:self.pos]

    def _unpack(self, fmt: str, size: int):
        return struct.unpack(fmt, self._take(size))[0]

    def _length(self, fmt: str) -> int:
        return self._unpack(fmt, _LENGTH[fmt])

    def decode(self) -> Any:
        b = self._unpack(">B", 1)
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0xa0 <= b <= 0xbf:
            return str(self._take(b & 0x1f), "utf-8")
        if 0x90 <= b <= 0x9f:
            return self._array(b & 0x0f)
        if 0x80 <= b <= 0x8f:
            return self._map(b & 0x0f)
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in _FIXED:
            return self._unpack(*_FIXED[b])
        if b in _STR:
            return str(self._take(self._length(_STR[b])), "utf-8")
        if b in _BIN:
            data = self._take(self._length(_BIN[b]))
            return data if self.views else bytes(data)
        if b in _ARRAY:
            return self._array(self._length(_ARRAY[b]))
        if b in _MAP:
            return self._map(self._length(_MAP[b]))
        if b in _FIXEXT:
            return self._ext(_FIXEXT[b])
        if b in _EXT:
            return self._ext(self._length(_EXT[b]))
        raise ValueError(f"invalid msgpack byte 0x{b:02x} at {self.pos - 1}")

    def _array(self, n: int) -> list:
        return [self.decode() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.decode()
            out[key] = self.decode()
        return out

    def _ext(self, n: int) -> Any:
        code = self._unpack(">b", 1)
        data = self._take(n)
        if code == EXT_NDARRAY:
            return _ndarray(data)
        if code == EXT_NPSCALAR:
            return _ndarray(data)[()]
        if code == EXT_NATIVE_COMPLEX:
            real, imag = _Decoder(data).decode()
            return complex(real, imag)
        return ExtType(code, bytes(data))


def _dtype(name: str) -> Tuple[np.dtype, bool]:
    """(the dtype of the buffer, whether it holds bfloat16)."""
    if name == "bfloat16":
        return np.dtype(np.uint16), True
    return np.dtype(name), False


def _ndarray(data: memoryview) -> np.ndarray:
    shape, name, buffer = _Decoder(data, views=True).decode()
    dtype, bf16 = _dtype(name)
    arr = np.frombuffer(buffer, dtype=dtype).reshape(shape)
    if bf16:   # the bfloat16 bits are a float32's upper half
        arr = (arr.astype(np.uint32) << 16).view(np.float32)
    return arr


def _unchunk(tree: Any) -> Any:
    """Chunked array maps back to arrays, everywhere in ``tree``."""
    if not isinstance(tree, dict):
        return tree
    if CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def loads(data) -> Any:
    """Decode one msgpack object (``bytes``, ``bytearray`` or a
    ``memoryview``) as ``flax.serialization.msgpack_restore`` would."""
    decoder = _Decoder(memoryview(data).cast("B"))
    out = decoder.decode()
    if decoder.pos != len(decoder.buf):
        raise ValueError(f"{len(decoder.buf) - decoder.pos} bytes of trailing "
                         "data after the msgpack object")
    return _unchunk(out)


def load(path: str) -> Any:
    """Read a flax msgpack file (one read of the whole file) and decode it."""
    with open(path, "rb") as f:
        data = f.read()
    return loads(data)
