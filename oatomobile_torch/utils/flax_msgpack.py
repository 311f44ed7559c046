"""Reads the JAX package's ``.flax`` checkpoints without msgpack or flax.

``flax.serialization.to_bytes`` writes a state dict with ``msgpack.packb``:
maps with str keys, nil, bools, ints, floats, str and bin, and arrays as
msgpack ext types: code 1 (``ndarray``) and code 3 (``npscalar``) hold a
msgpack array ``(shape, dtype name, C-order bytes)``; code 2
(``native_complex``) holds ``(real, imag)``.  Arrays over flax's 1 GiB
chunk size are maps ``{"__msgpack_chunked_array__": True, "shape": {"0":
..., ...}, "chunks": {"0": ..., ...}}``.  This module parses that subset into a tree
of dicts, lists and numpy arrays, as ``flax.serialization.msgpack_restore``
returns it.
"""

import struct
from typing import Any

import numpy as np

EXT_NDARRAY, EXT_NATIVE_COMPLEX, EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
  """A msgpack decoder over one bytes buffer."""

  def __init__(self, data: bytes, raw: bool = False) -> None:
    self._data = memoryview(data)
    self._pos = 0
    self._raw = raw

  def _take(self, n: int) -> memoryview:
    if self._pos + n > len(self._data):
      raise ValueError("msgpack data ends early")
    out = self._data[self._pos:self._pos + n]
    self._pos += n
    return out

  def _unpack(self, fmt: str):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, self._take(size))[0]

  def _str(self, n: int):
    raw = bytes(self._take(n))
    return raw if self._raw else raw.decode("utf-8")

  def _ext(self, code: int, n: int) -> Any:
    data = bytes(self._take(n))
    if code in (EXT_NDARRAY, EXT_NPSCALAR):
      shape, dtype, buffer = _Reader(data, raw=True).read_all()
      arr = np.frombuffer(buffer, dtype=np.dtype(dtype.decode())).reshape(
          shape, order="C").copy()
      return arr[()] if code == EXT_NPSCALAR else arr
    if code == EXT_NATIVE_COMPLEX:
      real, imag = _Reader(data).read_all()
      return complex(real, imag)
    raise ValueError("unknown msgpack ext type {}".format(code))

  def read(self) -> Any:  # pylint: disable=too-many-return-statements,too-many-branches
    b = self._unpack(">B")
    if b <= 0x7F:
      return b
    if b >= 0xE0:
      return b - 0x100
    if 0x80 <= b <= 0x8F:
      return self._map(b & 0x0F)
    if 0x90 <= b <= 0x9F:
      return self._array(b & 0x0F)
    if 0xA0 <= b <= 0xBF:
      return self._str(b & 0x1F)
    fixed = {0xC0: None, 0xC2: False, 0xC3: True}
    if b in fixed:
      return fixed[b]
    scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
               0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
    if b in scalars:
      return self._unpack(scalars[b])
    sizes = {0: ">B", 1: ">H", 2: ">I"}
    if 0xC4 <= b <= 0xC6:  # bin 8/16/32
      return bytes(self._take(self._unpack(sizes[b - 0xC4])))
    if 0xC7 <= b <= 0xC9:  # ext 8/16/32
      n = self._unpack(sizes[b - 0xC7])
      return self._ext(self._unpack(">b"), n)
    if 0xD4 <= b <= 0xD8:  # fixext 1/2/4/8/16
      code = self._unpack(">b")
      return self._ext(code, 1 << (b - 0xD4))
    if 0xD9 <= b <= 0xDB:  # str 8/16/32
      return self._str(self._unpack(sizes[b - 0xD9]))
    if b in (0xDC, 0xDD):  # array 16/32
      return self._array(self._unpack(sizes[b - 0xDB]))
    if b in (0xDE, 0xDF):  # map 16/32
      return self._map(self._unpack(sizes[b - 0xDD]))
    raise ValueError("unknown msgpack type byte 0x{:02x}".format(b))

  def _array(self, n: int) -> list:
    return [self.read() for _ in range(n)]

  def _map(self, n: int) -> dict:
    out = {}
    for _ in range(n):
      key = self.read()
      out[key] = self.read()
    return out

  def read_all(self) -> Any:
    value = self.read()
    if self._pos != len(self._data):
      raise ValueError("{} bytes after the msgpack value".format(
          len(self._data) - self._pos))
    return value


def _unchunk(tree: Any) -> Any:
  """Joins flax's chunked arrays back into arrays, recursively."""
  if not isinstance(tree, dict):
    return tree
  if tree.get(_CHUNKED):
    # flax stores the tuples ``shape`` and ``chunks`` as {"0": ..., ...}.
    as_tuple = lambda d: tuple(d[str(i)] for i in range(len(d)))  # pylint: disable=unnecessary-lambda-assignment
    return np.concatenate(as_tuple(tree["chunks"])).reshape(
        as_tuple(tree["shape"]))
  return {k: _unchunk(v) for k, v in tree.items()}


def from_bytes(data: bytes) -> Any:
  """The tree that ``flax.serialization.msgpack_restore(data)`` gives."""
  return _unchunk(_Reader(data).read_all())


def read(path: str) -> Any:
  """The tree of a ``.flax`` file."""
  with open(path, "rb") as fp:
    return from_bytes(fp.read())

