"""The port's hand-written CUDA kernels as :class:`Kernel` objects.

Each kernel is a ``csrc/*.cu`` source with a plain C entry point, built
with ``nvcc`` at first use into the port's build directory (rebuilt only
when a source is newer than the library) and loaded through ``ctypes``.
Its wrapper in ``ops/`` makes one ``Kernel`` and keeps what is its own:
the argument types (``declare``), the checks of its inputs and its plain
PyTorch version.

Every ``Kernel`` made is in ``KERNELS``.  Its ``launches`` counts the
launches its wrapper made; ``graphs.CapturedStep`` reads them all through
``KERNELS`` to count a graph's launches at each replay.
"""

import ctypes
import os
import shutil
from typing import Callable, Optional, Sequence

import torch

from oatomobile_torch import paths
from oatomobile_torch.native import build

CSRC = os.path.join(paths.PACKAGE_DIR, "csrc")
LIBRARY_DIR = os.path.join(paths.BUILD_DIR, "kernels")
# The nvcc flags every kernel starts and ends with: Hopper's sm_90a, and a
# shared library with ptxas's report of registers and shared memory.
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3")
SHARED = ("-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Every Kernel made, in the order made.
KERNELS = []


def find() -> str:
  """The path of ``nvcc``; raises when the CUDA toolkit is missing."""
  found = shutil.which("nvcc")
  if found:
    return found
  default = "/usr/local/cuda/bin/nvcc"
  if os.path.exists(default):
    return default
  raise RuntimeError("nvcc not found: the port's CUDA kernels are built at "
                     "first use and need the CUDA toolkit")


class Kernel:
  """The CUDA source ``csrc/<source>`` built with ``nvcc <flags>`` into
  ``lib<name>.so``; ``declare(lib)`` sets its C entry points' argument
  types on a loaded library and returns it."""

  def __init__(self, name: str, source: str, flags: Sequence[str],
               declare: Callable[[ctypes.CDLL], ctypes.CDLL],
               headers: Sequence[str] = ()) -> None:
    self.name = name
    self.source = os.path.join(CSRC, source)
    self.headers = tuple(os.path.join(CSRC, h) for h in headers)
    self.flags = tuple(flags)
    self.declare = declare
    self.path = os.path.join(LIBRARY_DIR, "lib{}.so".format(name))
    # Launches since import (or since the caller last reset it).
    self.launches = 0
    # What the last build printed (ptxas -v: registers, shared memory)
    # and its nvcc seconds, for the record.
    self.build_log = ""
    self.build_seconds = 0.0
    self._lib: Optional[ctypes.CDLL] = None
    KERNELS.append(self)

  def build(self, source: Optional[str] = None,
            library: Optional[str] = None) -> str:
    """Compiles ``source`` (the kernel's own by default; another design
    for comparison) into ``library`` (default ``path``) unless the library
    is newer than the source and the kernel's headers; returns the
    library's path."""
    library = library or self.path
    built = build.compile_library([find(), *self.flags],
                                  source or self.source, library,
                                  self.headers)
    if built is not None:
      self.build_log, self.build_seconds = built
    return library

  def library(self) -> ctypes.CDLL:
    """The kernel's library: built, loaded and declared at the first
    call."""
    if self._lib is None:
      self._lib = self.declare(ctypes.CDLL(self.build()))
    return self._lib

  @property
  def loaded(self) -> bool:
    return self._lib is not None

  def check(self, err: int) -> None:
    """Raises when the C entry point returned a CUDA error."""
    if err != 0:
      raise RuntimeError("{} kernel launch failed: CUDA error {}".format(
          self.name, err))


def check_input(name: str, x: torch.Tensor, shape, device,
                beside: str) -> None:
  """Raises unless ``x`` is float32 on ``device`` (that of the input named
  ``beside``) with ``shape`` (None: any extent)."""
  if x.dtype != torch.float32:
    raise TypeError("{} must be float32, got {}".format(name, x.dtype))
  if x.device != device:
    raise ValueError("{} is on {}, {} on {}".format(name, x.device, beside,
                                                    device))
  if x.dim() != len(shape) or any(
      want is not None and got != want for got, want in zip(x.shape, shape)):
    raise ValueError("{} must have shape {}, got {}".format(
        name, tuple("*" if s is None else s for s in shape), tuple(x.shape)))


def check_contiguous(named) -> None:
  """Raises unless every tensor of the (name, tensor) pairs is
  contiguous."""
  for name, x in named:
    if not x.is_contiguous():
      raise ValueError("{} must be contiguous".format(name))
