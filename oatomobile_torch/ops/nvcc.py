"""Builds a CUDA source into a shared library with ``nvcc``, for the
kernels' wrappers (``bev_cuda``, ``dim_plan_cuda``): a plain C entry point
loaded through ``ctypes``, built at first use into the port's build
directory and rebuilt only when a source is newer than the library."""

import os
import shutil
import subprocess
import tempfile
import time
from typing import Optional, Sequence, Tuple


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


def build(source: str, library: str, flags: Sequence[str],
          headers: Sequence[str] = ()) -> Optional[Tuple[str, float]]:
  """Compiles ``source`` into ``library`` with ``flags`` unless the library
  is newer than the source and every header it includes.  Returns None when
  the library was up to date, else (what nvcc printed, the seconds it
  took); raises when nvcc fails."""
  if (os.path.exists(library) and os.path.getmtime(library) >= max(
      os.path.getmtime(path) for path in (source, *headers))):
    return None
  os.makedirs(os.path.dirname(library), exist_ok=True)
  fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(library))
  os.close(fd)
  cmd = [find(), *flags, "-o", tmp, source]
  t0 = time.perf_counter()
  proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
  seconds = time.perf_counter() - t0
  log = proc.stdout + proc.stderr
  if proc.returncode != 0:
    os.unlink(tmp)
    raise RuntimeError("nvcc failed ({}):\n{}".format(" ".join(cmd), log))
  os.replace(tmp, library)
  return log, seconds
