"""Native (C++) host-runtime components.

The compute path is PyTorch on the GPU; host-side runtime pieces that are
hot at episode boundaries are native C++ with ctypes bindings, compiled
on first use into the port's own build directory (never the JAX
package's cache, so the two packages never race on one ``.so``).
Current components:

  - route_planner: batched BFS over the lane-waypoint CSR graph (episode
    route planning for large scene batches).
"""

import ctypes
import logging
import os
import subprocess
import tempfile
from typing import Optional

import numpy as np

from oatomobile_torch import paths

logger = logging.getLogger(__name__)

_SRC_DIR = os.path.dirname(os.path.abspath(__file__))
_CACHE_DIR = os.path.join(paths.BUILD_DIR, "native")

_lib: Optional[ctypes.CDLL] = None
_lib_failed = False


def _build_library() -> str:
  """Compiles route_planner.cc into a cached shared library."""
  os.makedirs(_CACHE_DIR, exist_ok=True)
  src = os.path.join(_SRC_DIR, "route_planner.cc")
  out = os.path.join(_CACHE_DIR, "libroute_planner.so")
  if (os.path.exists(out) and
      os.path.getmtime(out) >= os.path.getmtime(src)):
    return out
  with tempfile.NamedTemporaryFile(suffix=".so", dir=_CACHE_DIR,
                                   delete=False) as tmp:
    tmp_path = tmp.name
  cmd = ["g++", "-O3", "-shared", "-fPIC", "-o", tmp_path, src]
  subprocess.run(cmd, check=True, capture_output=True)
  os.replace(tmp_path, out)
  return out


def get_library() -> Optional[ctypes.CDLL]:
  """Returns the loaded native library, or None if unavailable."""
  global _lib, _lib_failed
  if _lib is not None or _lib_failed:
    return _lib
  try:
    path = _build_library()
    lib = ctypes.CDLL(path)
    lib.plan_routes.argtypes = [
        ctypes.POINTER(ctypes.c_int32),  # indptr
        ctypes.POINTER(ctypes.c_int32),  # indices
        ctypes.c_int32,                  # num_nodes
        ctypes.POINTER(ctypes.c_int32),  # origins
        ctypes.POINTER(ctypes.c_int32),  # dests
        ctypes.c_int32,                  # num_queries
        ctypes.c_int32,                  # capacity
        ctypes.POINTER(ctypes.c_int32),  # routes_out
        ctypes.POINTER(ctypes.c_int32),  # lengths_out
    ]
    lib.plan_routes.restype = None
    _lib = lib
  except Exception as exc:  # pylint: disable=broad-except
    logger.warning("native route planner unavailable (%s); "
                   "falling back to Python BFS", exc)
    _lib_failed = True
  return _lib


def _ptr(arr: np.ndarray):
  return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def plan_routes_native(indptr: np.ndarray, indices: np.ndarray,
                       origins: np.ndarray, dests: np.ndarray,
                       capacity: int):
  """Batched route planning; returns (routes [Q, capacity] i32,
  lengths [Q] i32) or None when the native library is unavailable."""
  lib = get_library()
  if lib is None:
    return None
  indptr = np.ascontiguousarray(indptr, dtype=np.int32)
  indices = np.ascontiguousarray(indices, dtype=np.int32)
  origins = np.ascontiguousarray(origins, dtype=np.int32)
  dests = np.ascontiguousarray(dests, dtype=np.int32)
  num_nodes = len(indptr) - 1
  num_queries = len(origins)
  routes = np.empty((num_queries, capacity), dtype=np.int32)
  lengths = np.empty((num_queries,), dtype=np.int32)
  lib.plan_routes(_ptr(indptr), _ptr(indices), num_nodes, _ptr(origins),
                  _ptr(dests), num_queries, capacity, _ptr(routes),
                  _ptr(lengths))
  return routes, lengths
