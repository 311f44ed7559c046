"""Shared helpers of the tests that hold oatomobile_torch against
oatomobile_tpu: numpy views of JAX pytrees and field-wise comparison, and
the host build of a CUDA kernel's source."""

import ctypes
import dataclasses
import os
import re
import shutil

import numpy as np
import pytest

from oatomobile_torch.native import build

CUDA_EMULATION = os.path.join(os.path.dirname(__file__), "cuda_emulation")
# Each launch `k<...><<<grid, block, smem, stream>>>(args)` of a source.
LAUNCH = re.compile(r"(\w+(?:<[^<>;]*>)?)<<<([^>]*)>>>\(([^;]*)\);")


def jax_state_to_numpy(state) -> dict:
  """A JAX SceneState (batched) as a dict of numpy arrays by field name,
  the input of ``oatomobile_torch.sim.types.scene_state_from_numpy``."""
  out = {}
  for f in dataclasses.fields(state):
    value = getattr(state, f.name)
    if f.name in ("pid_lat", "pid_lon"):
      out[f.name] = {"err_buf": np.asarray(value.err_buf),
                     "prev_error": np.asarray(value.prev_error)}
    else:
      out[f.name] = np.asarray(value)
  return out


def jax_params_to_numpy(params) -> dict:
  """A JAX WorldParams as the input of ``world_params_from_numpy``."""
  return {
      "map": {k: np.asarray(v) for k, v in params.map.items()},
      "vehicle": {f.name: np.asarray(getattr(params.vehicle, f.name))
                  for f in dataclasses.fields(params.vehicle)},
      **{name: np.asarray(getattr(params, name))
         for name in ("dt", "npc_target_speed", "tl_green", "tl_yellow",
                      "proximity_vehicle_threshold",
                      "proximity_tlight_threshold")},
      "wall_budget": params.wall_budget,
      "road_budget": params.road_budget,
  }


def flatten(d: dict, prefix: str = "") -> dict:
  out = {}
  for k, v in d.items():
    if isinstance(v, dict):
      out.update(flatten(v, prefix + k + "."))
    else:
      out[prefix + k] = v
  return out


def assert_states_match(expected: dict, actual: dict, atol: float,
                        atol_by_field=None) -> None:
  """Integer and bool fields equal; float fields within ``atol`` (or the
  field's entry of ``atol_by_field``); shapes and dtypes equal."""
  expected, actual = flatten(expected), flatten(actual)
  assert set(expected) == set(actual)
  atol_by_field = atol_by_field or {}
  for name, want in expected.items():
    got = actual[name]
    assert got.shape == want.shape, (name, got.shape, want.shape)
    assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
    if want.dtype.kind == "f":
      np.testing.assert_allclose(got, want, rtol=0,
                                 atol=atol_by_field.get(name, atol),
                                 err_msg=name)
    else:
      np.testing.assert_array_equal(got, want, err_msg=name)


def fraction_beyond(a: np.ndarray, b: np.ndarray, atol: float) -> float:
  """Fraction of elements where |a - b| > atol."""
  return float(np.mean(np.abs(np.asarray(a) - np.asarray(b)) > atol))


def emulated_library(kernel, tmp_dir, *, launches: int,
                     prelude: str) -> ctypes.CDLL:
  """``kernel``'s CUDA source (a ``native.nvcc.Kernel``) built by g++ for
  the CPU into ``tmp_dir``, each CUDA thread a host thread
  (``cuda_emulation/cuda_runtime.h``): its ``launches`` launches rewritten
  as ``emulate_launch`` calls, ``prelude`` (the shared memory and what the
  host lacks) before it; loaded and declared.  Skips without g++."""
  if shutil.which("g++") is None:
    pytest.skip("needs g++ to build the kernel's source for the CPU")
  with open(kernel.source) as fp:
    source = fp.read()
  assert len(LAUNCH.findall(source)) == launches
  unit = os.path.join(str(tmp_dir), kernel.name + "_emulated.cc")
  with open(unit, "w") as fp:
    fp.write("#include <cuda_runtime.h>\n" + prelude +
             LAUNCH.sub(r"emulate_launch(\1, \2, \3);", source))
  library = os.path.join(str(tmp_dir), "lib{}_emulated.so".format(
      kernel.name))
  build.compile_library(["g++", "-std=c++20", "-O1", "-ffp-contract=off",
                         "-shared", "-fPIC", "-pthread", "-I",
                         CUDA_EMULATION], unit, library)
  return kernel.declare(ctypes.CDLL(library))
