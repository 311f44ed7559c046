"""Minimal, dependency-free observation/action space primitives: a copy
of the JAX package's ``utils/spaces.py``.

An API-compatible subset of ``gym.spaces`` (gym is not a dependency):
``Box``, ``Discrete`` and ``Dict`` with ``sample()``/``contains()``/
``shape``/``dtype``.
"""

from typing import Any, Mapping, Optional, Sequence, Tuple, Union

import numpy as np


class Space:
  """Base class for observation/action spaces."""

  def __init__(self,
               shape: Optional[Tuple[int, ...]] = None,
               dtype: Any = None) -> None:
    self.shape = None if shape is None else tuple(shape)
    self.dtype = None if dtype is None else np.dtype(dtype)
    self._rng = np.random.RandomState()

  def seed(self, seed: Optional[int] = None) -> None:
    self._rng = np.random.RandomState(seed)

  def sample(self) -> Any:
    raise NotImplementedError

  def contains(self, x: Any) -> bool:
    raise NotImplementedError


class Box(Space):
  """A (possibly unbounded) box in R^n."""

  def __init__(self,
               low: Union[float, np.ndarray],
               high: Union[float, np.ndarray],
               shape: Optional[Sequence[int]] = None,
               dtype: Any = np.float32) -> None:
    if shape is None:
      shape = np.broadcast(np.asarray(low), np.asarray(high)).shape
    super().__init__(tuple(shape), dtype)
    self.low = np.broadcast_to(np.asarray(low, dtype=self.dtype), self.shape)
    self.high = np.broadcast_to(np.asarray(high, dtype=self.dtype), self.shape)

  def sample(self) -> np.ndarray:
    low = np.where(np.isfinite(self.low), self.low, -1.0)
    high = np.where(np.isfinite(self.high), self.high, 1.0)
    return self._rng.uniform(low=low, high=high,
                             size=self.shape).astype(self.dtype)

  def contains(self, x: Any) -> bool:
    x = np.asarray(x)
    return (x.shape == self.shape and np.all(x >= self.low) and
            np.all(x <= self.high))

  def __repr__(self) -> str:
    return "Box({}, {}, {}, {})".format(self.low.min(), self.high.max(),
                                        self.shape, self.dtype)


class Discrete(Space):
  """A discrete space {0, 1, ..., n-1}."""

  def __init__(self, n: int) -> None:
    super().__init__((), np.int64)
    self.n = int(n)

  def sample(self) -> int:
    return int(self._rng.randint(self.n))

  def contains(self, x: Any) -> bool:
    return 0 <= int(x) < self.n

  def __repr__(self) -> str:
    return "Discrete({})".format(self.n)


class Dict(Space):
  """A dictionary of component spaces."""

  def __init__(self,
               spaces: Optional[Mapping[str, Space]] = None,
               **kwargs: Space) -> None:
    super().__init__(None, None)
    self.spaces = dict(spaces or {})
    self.spaces.update(kwargs)

  def sample(self) -> Mapping[str, Any]:
    return {key: space.sample() for key, space in self.spaces.items()}

  def contains(self, x: Any) -> bool:
    if not isinstance(x, dict):
      return False
    return all(key in x and space.contains(x[key])
               for key, space in self.spaces.items())

  def __getitem__(self, key: str) -> Space:
    return self.spaces[key]

  def __iter__(self):
    return iter(self.spaces)

  def items(self):
    return self.spaces.items()

  def keys(self):
    return self.spaces.keys()

  def values(self):
    return self.spaces.values()

  def __repr__(self) -> str:
    return "Dict({})".format(self.spaces)
