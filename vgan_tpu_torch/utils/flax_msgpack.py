"""A reader of Flax's msgpack checkpoints, in the standard library and numpy.

``vgan_tpu`` writes its generator and detector parameters with
``flax.serialization.to_bytes``: a msgpack map of the parameter tree whose
array leaves are msgpack extension objects. The port imports neither
``flax`` nor ``msgpack``, so this module decodes that layout itself:

- the msgpack types a parameter tree uses: maps, arrays, str, bin, ints,
  floats, bool and nil;
- extension type 1, an ndarray: an inner msgpack array ``(shape, dtype
  name as bytes, C-order buffer)``; extension 3, a numpy scalar in the same
  form; extension 2, a complex number as an inner ``(real, imag)``;
- a leaf over ``2**30`` bytes, which Flax splits into
  ``{'__msgpack_chunked_array__': True, 'shape': {...}, 'chunks': {...}}``
  (tuples are written as maps keyed ``'0'``, ``'1'``, ...).

Array leaves come back as numpy arrays, except ``bfloat16`` ones, which
numpy lacks: they come back as ``torch.bfloat16`` tensors (the buffer read
as ``uint16`` and viewed).
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any, Tuple

import numpy as np
import torch

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    """A cursor over msgpack bytes; ``raw`` keeps str values as bytes."""

    def __init__(self, data: bytes, raw: bool):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(">" + fmt)))[0]

    def str_(self, n: int):
        b = self.take(n)
        return b if self.raw else b.decode("utf-8")

    def ext(self, n: int):
        code = self.unpack("b")
        return _ext_value(code, self.take(n))

    def value(self) -> Any:
        t = self.take(1)[0]
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map_(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return self.array_(t & 0x0F)
        if 0xA0 <= t <= 0xBF:
            return self.str_(t & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if t in simple:
            return simple[t]
        sized = {
            0xC4: ("B", self.take), 0xC5: ("H", self.take), 0xC6: ("I", self.take),
            0xC7: ("B", self.ext), 0xC8: ("H", self.ext), 0xC9: ("I", self.ext),
            0xD9: ("B", self.str_), 0xDA: ("H", self.str_), 0xDB: ("I", self.str_),
            0xDC: ("H", self.array_), 0xDD: ("I", self.array_),
            0xDE: ("H", self.map_), 0xDF: ("I", self.map_),
        }
        if t in sized:
            fmt, read = sized[t]
            return read(self.unpack(fmt))
        scalars = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I", 0xCF: "Q",
                   0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if t in scalars:
            return self.unpack(scalars[t])
        if 0xD4 <= t <= 0xD8:  # fixext 1, 2, 4, 8, 16
            return self.ext(1 << (t - 0xD4))
        raise ValueError(f"msgpack type byte 0x{t:02x} is not supported")

    def array_(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map_(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


def _unpackb(data: bytes, raw: bool) -> Any:
    reader = _Reader(data, raw)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack object")
    return out


def _ndarray(data: bytes):
    """Flax's ``_ndarray_from_bytes``: a numpy array, or a bfloat16 tensor."""
    shape, dtype_name, buffer = _unpackb(data, raw=True)
    shape = tuple(int(s) for s in shape)
    if dtype_name == b"bfloat16":
        bits = np.frombuffer(buffer, dtype=np.uint16).reshape(shape).copy()
        return torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())).reshape(shape)


def _ext_value(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        return _ndarray(data)
    if code == _EXT_NPSCALAR:
        arr = _ndarray(data)
        return arr.reshape(()) if isinstance(arr, torch.Tensor) else arr[()]
    if code == _EXT_COMPLEX:
        real, imag = _unpackb(data, raw=False)
        return complex(real, imag)
    raise ValueError(f"msgpack extension type {code} is not a Flax leaf")


def _tuple(d: dict) -> Tuple:
    return tuple(d[str(i)] for i in range(len(d)))


def _unchunk(d: dict):
    shape = tuple(int(s) for s in _tuple(d["shape"]))
    chunks = _tuple(d["chunks"])
    if chunks and isinstance(chunks[0], torch.Tensor):
        return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
    return np.concatenate([np.asarray(c).reshape(-1) for c in chunks]).reshape(shape)


def _unchunk_leaves(tree):
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            return _unchunk(tree)
        return {k: _unchunk_leaves(v) for k, v in tree.items()}
    return tree


def msgpack_restore(data: bytes):
    """The tree ``flax.serialization.msgpack_restore`` returns for ``data``
    (bfloat16 leaves as ``torch.bfloat16`` tensors)."""
    return _unchunk_leaves(_unpackb(bytes(data), raw=False))


def load_msgpack(path):
    """:func:`msgpack_restore` of a file's bytes."""
    return msgpack_restore(Path(path).read_bytes())
