"""Builds a C++ or CUDA source into a shared library when it is stale.

The one build rule of the port's native code (the route planner's g++
build, the CUDA kernels' nvcc builds in ``native/nvcc.py``, the tests'
host builds): rebuild unless the library is newer than the source and
every header it includes, into a temporary file beside the library that
replaces it only when the compiler succeeded.  Imports no torch.
"""

import os
import subprocess
import tempfile
import time
from typing import Optional, Sequence, Tuple


def compile_library(command: Sequence[str], source: str, library: str,
                    headers: Sequence[str] = ()
                    ) -> Optional[Tuple[str, float]]:
  """Runs ``command -o <library> <source>`` (``command`` is the compiler
  and its flags) unless ``library`` is newer than ``source`` and every
  header.  Returns None when the library was up to date, else (what the
  compiler printed, the seconds it took); raises RuntimeError with the
  compiler's output when it fails, and leaves no temporary file."""
  if (os.path.exists(library) and os.path.getmtime(library) >= max(
      os.path.getmtime(path) for path in (source, *headers))):
    return None
  os.makedirs(os.path.dirname(library), exist_ok=True)
  fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(library))
  os.close(fd)
  cmd = [*command, "-o", tmp, source]
  t0 = time.perf_counter()
  try:
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
      raise RuntimeError("{} failed ({}):\n{}".format(
          os.path.basename(command[0]), " ".join(cmd),
          proc.stdout + proc.stderr))
  except BaseException:
    os.unlink(tmp)
    raise
  os.replace(tmp, library)
  return proc.stdout + proc.stderr, seconds
