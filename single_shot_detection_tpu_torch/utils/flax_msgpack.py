"""Read the JAX package's checkpoints without flax or msgpack.

The JAX package writes ``ckpt-N.msgpack`` with ``flax.serialization.to_bytes``
(``single_shot_detection_tpu/train/checkpoint.py``) and reads it back with
``msgpack_restore``.  This module is a pure-Python and numpy reader for the
subset of MessagePack that flax writes, so the port can load those files on
a machine that has neither package:

- nil, bool, ints and floats of every width, str, bin, arrays (returned as
  lists, as ``msgpack.unpackb`` returns them) and maps;
- flax's ext types: 1, an ndarray, stored as a nested msgpack
  ``(shape, dtype name, C-order bytes)``; 3, a numpy scalar, the same
  unpacked to a scalar; 2, a Python complex, a nested ``(real, imag)``;
- flax's chunked form of leaves over 2**30 bytes (a map holding
  ``__msgpack_chunked_array__``), rebuilt into one array as
  ``msgpack_restore`` does.

Arrays come back as writable numpy arrays.  ``bfloat16`` leaves are read as
their raw 16-bit patterns and widened to float32, which is exact; no
``ml_dtypes`` is needed.  Any other MessagePack type raises ``ValueError``.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

_CHUNKED = '__msgpack_chunked_array__'

# fixed-width headers: first byte -> (struct format, byte count)
_UINTS = {0xcc: ('>B', 1), 0xcd: ('>H', 2), 0xce: ('>I', 4), 0xcf: ('>Q', 8)}
_INTS = {0xd0: ('>b', 1), 0xd1: ('>h', 2), 0xd2: ('>i', 4), 0xd3: ('>q', 8)}
_FLOATS = {0xca: ('>f', 4), 0xcb: ('>d', 8)}
_LENGTHS = {1: '>B', 2: '>H', 4: '>I'}
# variable-length headers: first byte -> (kind, bytes of the length field)
_SIZED = {0xc4: ('bin', 1), 0xc5: ('bin', 2), 0xc6: ('bin', 4),
          0xd9: ('str', 1), 0xda: ('str', 2), 0xdb: ('str', 4),
          0xdc: ('array', 2), 0xdd: ('array', 4),
          0xde: ('map', 2), 0xdf: ('map', 4),
          0xc7: ('ext', 1), 0xc8: ('ext', 2), 0xc9: ('ext', 4)}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


class _Reader:
    def __init__(self, data: bytes, raw: bool = False):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw  # strings as bytes, as ``unpackb(raw=True)``

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError('truncated msgpack data')
        out = self.data[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str, n: int):
        return struct.unpack(fmt, self.take(n))[0]

    def read(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.read_map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return self.read_array(b & 0x0f)
        if 0xa0 <= b <= 0xbf:
            return self.read_str(b & 0x1f)
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        for table in (_UINTS, _INTS, _FLOATS):
            if b in table:
                return self.unpack(*table[b])
        if b in _FIXEXT:
            return self.read_ext(_FIXEXT[b])
        if b in _SIZED:
            kind, width = _SIZED[b]
            n = self.unpack(_LENGTHS[width], width)
            if kind == 'bin':
                return bytes(self.take(n))
            if kind == 'str':
                return self.read_str(n)
            if kind == 'array':
                return self.read_array(n)
            if kind == 'map':
                return self.read_map(n)
            return self.read_ext(n)
        raise ValueError(f'unsupported msgpack type byte 0x{b:02x} at '
                         f'offset {self.pos - 1}')

    def read_str(self, n: int):
        data = bytes(self.take(n))
        return data if self.raw else data.decode('utf-8')

    def read_array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def read_map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def read_ext(self, n: int):
        code = self.unpack('>b', 1)
        data = bytes(self.take(n))
        if code == 1:
            return _ndarray(data)
        if code == 3:
            return _ndarray(data)[()]
        if code == 2:
            real, imag = unpackb(data)
            return complex(real, imag)
        raise ValueError(f'unsupported msgpack ext type {code}')


def _ndarray(data: bytes) -> np.ndarray:
    """flax's ``_ndarray_from_bytes``: a nested ``(shape, dtype name,
    bytes)``; bfloat16 widened to float32."""
    shape, name, buffer = _Reader(data, raw=True).read()
    name = name.decode('ascii')
    shape: Tuple[int, ...] = tuple(shape)
    if name == 'bfloat16':
        bits = np.frombuffer(buffer, dtype='<u2').astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(name)).reshape(shape).copy()


def unpackb(data: bytes) -> Any:
    """One MessagePack object from ``data`` (all of it must be used)."""
    reader = _Reader(data)
    out = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError(f'{len(reader.data) - reader.pos} bytes left after '
                         'the msgpack object')
    return out


def _unchunk(tree):
    """flax's ``_unchunk_array_leaves_in_place``."""
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(tree['shape'][str(i)] for i in range(len(tree['shape'])))
        chunks = [tree['chunks'][str(i)] for i in range(len(tree['chunks']))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data: bytes) -> Any:
    """The tree that ``flax.serialization.msgpack_restore(data)`` returns,
    with bfloat16 leaves as float32."""
    return _unchunk(unpackb(data))


def read(path: str) -> Any:
    """Restore a ``ckpt-N.msgpack`` file of the JAX package."""
    with open(path, 'rb') as f:
        return msgpack_restore(f.read())
