"""The diagnostics whose JAX scripts define their rollout at module level
(``scripts/diag_hero_stops.py``, ``diag_stalls.py``, ``diag_town02.py``)
against ``oatomobile_torch.experiments.diag`` on the CPU: the same tasks,
seeds and horizon through the JAX script's jitted ``rollout`` and the
port's captured step (eager on the CPU), accumulators compared key by
key.  Integer and boolean counters must be equal.  Float accumulators
within ``float_atol(horizon)``: one step's floats agree to STEP_ATOL
(``tests/test_torch_sim.py``: XLA fuses ``x*y + z`` into an FMA on the
CPU and torch rounds twice), so a float summed over H steps is held to H
times that, and never tighter than FLOAT_ATOL (1e-4, the bound of a
16-step run).
"""

import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch

from oatomobile_torch.experiments.diag import hero_stops, stalls, town02
from oatomobile_tpu.benchmarks.corl2017.benchmark import _TASKS as JTASKS
from oatomobile_tpu.maps import load_town as jload_town
from oatomobile_tpu.sim import init_scene_batch as jinit_scene_batch
from oatomobile_tpu.sim import make_params as jmake_params

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_ATOL = 1e-5
FLOAT_ATOL = 1e-4
TOWN = "Town02"


def jax_diag(name: str):
  """``scripts/diag_<name>.py`` imported as a module (nothing runs)."""
  spec = importlib.util.spec_from_file_location(
      "jax_diag_" + name, os.path.join(ROOT, "scripts",
                                       "diag_" + name + ".py"))
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module


def jax_scenes(ids, episodes: int, seed: int):
  """(params, states) as the JAX scripts build them: scene ``e * T + i``
  is episode e of task ids[i]."""
  configs = [JTASKS[t] for t in ids]
  town = jload_town(configs[0]["town"])

  def tiled(key, default=0):
    return np.tile(np.asarray([int(c.get(key, default)) for c in configs]),
                   episodes)

  states = jinit_scene_batch(
      town, len(ids) * episodes, num_vehicles=tiled("num_vehicles"),
      num_pedestrians=tiled("num_pedestrians"), route_capacity=2048,
      seed=seed,
      spawn_points=np.tile(np.asarray([c["origin"] for c in configs]),
                           episodes),
      destinations=np.tile(np.asarray([c["destination"] for c in configs]),
                           episodes))
  return jmake_params(town), states


def jax_rollout(module, ids, episodes, seed, horizon):
  params, states = jax_scenes(ids, episodes, seed)
  final, m = jax.device_get(jax.jit(
      lambda p, s: module.rollout(p, s, horizon))(params, states))
  return final, {k: np.asarray(v) for k, v in m.items()}


def float_atol(horizon: int) -> float:
  return max(FLOAT_ATOL, STEP_ATOL * horizon)


def assert_accumulators_match(got: dict, want: dict, atol: float) -> None:
  assert sorted(got) == sorted(want)
  for k, w in want.items():
    g = got[k]
    assert g.shape == w.shape and g.dtype == w.dtype, k
    if w.dtype.kind == "f":
      np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=k)
    else:
      np.testing.assert_array_equal(g, w, err_msg=k)


def test_hero_stops_matches_jax():
  scenes, horizon = 6, 160
  ids, _ = hero_stops.task_configs(TOWN, scenes)
  _, want = jax_rollout(jax_diag("hero_stops"), ids, 1, 0, horizon)
  got = hero_stops.run(TOWN, scenes, horizon, device="cpu")
  assert_accumulators_match(got["m"], want, float_atol(horizon))
  # The rollout reaches hard stops, whose share the report prints.
  assert want["hard"].sum() > 0 and want["stopped"].sum() > 0
  lines = hero_stops.report(got)
  assert lines[0].startswith("{} x {} scenes: hero stopped".format(TOWN,
                                                                   scenes))
  assert len(lines) == 2 + len(hero_stops.KEYS)


def test_hero_stop_causes_match_jax_on_one_state():
  """The cause flags of one mid-rollout state, scene by scene against the
  JAX script's one-scene function under ``vmap``."""
  module = jax_diag("hero_stops")
  ids, configs = hero_stops.task_configs(TOWN, 6)
  final, _ = jax_rollout(module, ids, 1, 0, 120)
  jparams, _ = jax_scenes(ids, 1, 0)
  want = jax.device_get(jax.vmap(
      lambda s: module.hero_stop_causes(jparams, s))(final))
  from oatomobile_torch.sim.types import scene_state_from_numpy  # pylint: disable=import-outside-toplevel
  from torch_port_helpers import jax_state_to_numpy  # pylint: disable=import-outside-toplevel
  params, _ = hero_stops.common.scenes(TOWN, configs, 1, 0, "cpu")
  state = scene_state_from_numpy(jax_state_to_numpy(final), "cpu")
  got = hero_stops.hero_stop_causes(params, state)
  assert sorted(got) == sorted(want) == sorted(hero_stops.KEYS)
  for k in hero_stops.KEYS:
    np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                  err_msg=k)


def test_stalls_matches_jax():
  scenes, horizon = 3, 48
  ids, _ = stalls.task_configs(TOWN, scenes)
  jfinal, want = jax_rollout(jax_diag("stalls"), ids, 1, 0, horizon)
  got = stalls.run(TOWN, scenes, horizon, device="cpu")
  assert_accumulators_match(got["m"], want, float_atol(horizon))
  assert want["stall_steps"].sum() > 0 and want["red_stall_steps"].sum() > 0
  assert got["alive"] == int(np.asarray(jfinal.npc_alive).sum())
  lines = stalls.report(got)
  assert lines[0] == "{} FullTown x {} scenes, horizon {}".format(
      TOWN, scenes, horizon)
  assert len([x for x in lines if "streak >" in x]) == len(stalls.THRESHOLDS)


@pytest.fixture(scope="module")
def town02_runs(tmp_path_factory):
  """The JAX script's rows (``--out``) and the port's, one episode of
  every Town02 task at 16 steps."""
  out = tmp_path_factory.mktemp("town02")
  horizon = 16
  module = jax_diag("town02")
  with pytest.MonkeyPatch.context() as mp:
    mp.setattr("sys.argv", ["diag_town02.py", "--episodes", "1",
                            "--horizon", str(horizon), "--out",
                            str(out / "jax.json")])
    module.main()
  town02.main(["--cpu", "--episodes", "1", "--horizon", str(horizon),
               "--out", str(out / "torch.json")])
  rows = {}
  for side in ("jax", "torch"):
    with open(out / (side + ".json")) as fp:
      rows[side] = json.load(fp)
  return module, rows


def test_town02_rows_match_jax(town02_runs):
  _, rows = town02_runs
  got, want = rows["torch"], rows["jax"]
  assert len(got) == len(want) == 75
  for g, w in zip(got, want):
    assert list(g) == list(w)  # the JAX layout, key for key
    for k, v in w.items():
      if isinstance(v, float):
        assert abs(g[k] - v) <= FLOAT_ATOL, k
      else:
        assert g[k] == v, k


def test_town02_accumulators_match_jax(town02_runs):
  module, _ = town02_runs
  ids = sorted(t for t, c in JTASKS.items() if c["town"] == TOWN)
  _, want = jax_rollout(module, ids, 1, 0, 16)
  got = town02.run(TOWN, 1, 16, device="cpu")
  assert got["ids"] == ids
  assert_accumulators_match(got["m"], want, FLOAT_ATOL)
  assert want["stopped_steps"].sum() > 0
