"""oatomobile_torch.maps (a copy of the host-side map stack) against
oatomobile_tpu.maps: towns, map tensors and batched routes are equal."""

import dataclasses
import glob
import json
import os

import numpy as np
import pytest
import torch

from oatomobile_torch.maps import load_town as torch_load_town
from oatomobile_torch.maps import plan_route_batch as torch_plan_route_batch
from oatomobile_tpu.maps import load_town as jax_load_town
from oatomobile_tpu.maps import plan_route_batch as jax_plan_route_batch

torch.set_num_threads(1)

TOWNS = ["Town01", "Town02", "Town03", "Town04", "Town05"]

_TORCH_DTYPE = {np.dtype(np.float32): torch.float32,
                np.dtype(np.int32): torch.int32,
                np.dtype(np.bool_): torch.bool}


@pytest.mark.parametrize("name", TOWNS)
def test_town_arrays_equal(name):
  want, got = jax_load_town(name), torch_load_town(name)
  for f in dataclasses.fields(want):
    if f.name == "_device":
      continue
    a, b = getattr(want, f.name), getattr(got, f.name)
    if isinstance(a, np.ndarray):
      assert a.dtype == b.dtype, f.name
      np.testing.assert_array_equal(b, a, err_msg=f.name)
    else:
      assert a == b, f.name


@pytest.mark.parametrize("name", TOWNS)
def test_tensors_equal_device_arrays(name):
  want = jax_load_town(name).device_arrays()
  got = torch_load_town(name).tensors("cpu")
  assert set(got) == set(want)
  for key, value in want.items():
    value = np.asarray(value)
    assert got[key].dtype == _TORCH_DTYPE[value.dtype], key
    assert got[key].device.type == "cpu"
    np.testing.assert_array_equal(got[key].numpy(), value, err_msg=key)


@pytest.mark.parametrize("name", TOWNS)
def test_plan_route_batch_equal(name):
  jt, tt = jax_load_town(name), torch_load_town(name)
  rs = np.random.RandomState(3)
  origins = jt.spawn_wp[rs.randint(jt.num_spawn_points, size=64)]
  dests = jt.spawn_wp[rs.randint(jt.num_spawn_points, size=64)]
  want = jax_plan_route_batch(jt, origins, dests, 1024)
  got = torch_plan_route_batch(tt, origins, dests, 1024)
  for a, b in zip(want, got):
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(b, a)


def test_benchmark_task_table_matches_configs():
  # The port reads town-building task fields from its own compact table;
  # it must list every CARNOVEL and CoRL2017 config in the same order.
  root = os.path.join(os.path.dirname(__file__), "..", "oatomobile_tpu",
                      "benchmarks")
  want = []
  for suite in ("carnovel", "corl2017"):
    for path in sorted(glob.glob(os.path.join(root, suite, "configs",
                                              "*.json"))):
      with open(path) as fp:
        config = json.load(fp)
      want.append([suite, os.path.basename(path), config["town"],
                   config["origin"], config["destination"]])
  table = os.path.join(os.path.dirname(__file__), "..", "oatomobile_torch",
                       "maps", "benchmark_tasks.json")
  with open(table) as fp:
    got = [[r["suite"], r["file"], r["town"], r["origin"], r["destination"]]
           for r in json.load(fp)]
  assert got == want
