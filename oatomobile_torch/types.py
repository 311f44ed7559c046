"""Core data structures and type definitions: a copy of the JAX package's
``types.py`` (Singleton, Shape, Scalar)."""

from typing import Sequence, Union


class Singleton(type):
  """Metaclass implementing the singleton pattern."""

  _instances = {}

  def __call__(cls, *args, **kwargs):
    if cls not in cls._instances:
      cls._instances[cls] = super(Singleton, cls).__call__(*args, **kwargs)
    return cls._instances[cls]


Shape = Union[int, Sequence[int]]
Scalar = Union[float, int]
