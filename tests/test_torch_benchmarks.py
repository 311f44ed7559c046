"""oatomobile_torch.benchmarks against oatomobile_tpu.benchmarks on the
CPU: the suites' tasks, configs and metrics, the summaries, and
``evaluate_batched`` with the autopilot and with a RIP ensemble (seeded
numpy weights carried across by ``oatomobile_torch.models.convert``)."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from oatomobile_torch import models as tmodels
from oatomobile_torch.baselines.learned.rip.agent import stack_ensemble
from oatomobile_torch.baselines.learned.rip.policy import make_rip_policy
from oatomobile_torch.benchmarks import batched_eval as teval
from oatomobile_torch.benchmarks import carnovel, corl2017, run
from oatomobile_torch.benchmarks.carnovel import benchmark as tcarnovel
from oatomobile_torch.benchmarks.corl2017 import benchmark as tcorl2017
from oatomobile_torch.models import convert
from oatomobile_tpu.baselines.learned.rip.agent import \
    stack_ensemble as jstack_ensemble
from oatomobile_tpu.baselines.learned.rip.policy import \
    make_rip_policy as jmake_rip_policy
from oatomobile_tpu.benchmarks import batched_eval as jeval
from oatomobile_tpu.benchmarks.carnovel import benchmark as jcarnovel
from oatomobile_tpu.benchmarks.corl2017 import benchmark as jcorl2017
from test_torch_policies import _jax_dim

torch.set_num_threads(1)

# Two Town02 tasks of the JAX package's tests (tests/test_benchmarks.py).
TASKS = {
    "Town02_Straight0-v0": {"town": "Town02", "origin": 10,
                            "destination": 40, "num_vehicles": 2,
                            "num_pedestrians": 0},
    "Town02_Turn0-v0": {"town": "Town02", "origin": 5, "destination": 60,
                        "num_vehicles": 2, "num_pedestrians": 0},
}
EPISODE_KEYS = ("steps", "collisions", "lane_invasions", "distance",
                "returns", "success")
# Distance summed over an episode of autopilot steps: each step's
# positions agree to 1e-5 (tests/test_torch_sim.py); 1e-3 m over an
# episode (the runs below agree exactly on this CPU).
DISTANCE_ATOL = 1e-3
# A RIP episode: the plans agree to ~1e-5 m and the bridge's steer to
# 2.5e-3 (tests/test_torch_policies.py), and each step's steer moves the
# hero further apart: over 8 steps 1e-2 m holds (the run below agrees
# exactly on this CPU).
RIP_DISTANCE_ATOL = 1e-2


def test_task_counts():
  assert len(carnovel.tasks) == 27
  assert len(corl2017.tasks) == 150


def test_task_families():
  families = {"AbnormalTurns", "BusyTown", "Hills", "Roundabouts"}
  for task_id in carnovel.tasks:
    assert teval.task_family(task_id) in families, task_id
  for task_id in corl2017.tasks:
    assert task_id.startswith(("Town01", "Town02")), task_id
  for task_id in list(carnovel.tasks) + list(corl2017.tasks):
    assert teval.task_family(task_id) == jeval.task_family(task_id)


def test_metrics_sets():
  assert {m.uuid for m in carnovel.metrics} == {
      "steps", "collisions", "lane_invasions", "distance", "returns"
  }
  assert {m.uuid for m in corl2017.metrics} == {
      "steps", "collisions", "lane_invasions"
  }


def test_load_unknown_task_raises():
  with pytest.raises(ValueError):
    carnovel.load("NotATask-v0")


@pytest.mark.parametrize("port,jax_module", [(tcarnovel, jcarnovel),
                                             (tcorl2017, jcorl2017)],
                         ids=["carnovel", "corl2017"])
def test_configs_equal_the_jax_package(port, jax_module):
  assert port._TASKS == jax_module._TASKS  # pylint: disable=protected-access
  for task_id in port._TASKS:  # pylint: disable=protected-access
    name = task_id + ".json"
    with open(os.path.join(os.path.dirname(port.__file__), "configs",
                           name), "rb") as fp:
      ours = fp.read()
    with open(os.path.join(os.path.dirname(jax_module.__file__), "configs",
                           name), "rb") as fp:
      assert fp.read() == ours, name


def test_tasks_load_on_the_benchmark_device():
  env = carnovel.tasks["Hills0-v0"].keywords
  assert env["device"] == "cuda" and env["town"] == "Town03"
  cpu = type(corl2017)(device="cpu")
  assert all(f.keywords["device"] == "cpu" for f in cpu.tasks.values())


SUMMARY_FIXTURE = {
    "Hills0-v0": {"episodes": [
        {"success": True, "collisions": 0, "distance": 100.0},
        {"success": False, "collisions": 1, "distance": 20.0},
    ]},
    "Hills1-v0": {"episodes": [
        {"success": False, "collisions": 0, "distance": 300.0},  # timeout
        {"success": True, "collisions": 0, "distance": 120.0},
    ]},
    "Roundabouts0-v0": {"success": False, "collisions": 2,
                        "distance": 10.0},
}


def test_summarize_per_family_and_timeouts():
  assert teval.task_family("AbnormalTurns5-v0") == "AbnormalTurns"
  assert teval.task_family("Town01_Turn22-v0") == "Town01_Turn"
  s = teval.summarize(SUMMARY_FIXTURE)
  assert s == jeval.summarize(SUMMARY_FIXTURE)
  assert s["num_tasks"] == 3
  assert s["episodes"] == 5
  assert abs(s["success_rate"] - 2 / 5) < 1e-9
  assert abs(s["collision_rate"] - 2 / 5) < 1e-9
  assert abs(s["timeout_rate"] - 1 / 5) < 1e-9
  fam = s["per_family"]
  assert set(fam) == {"Hills", "Roundabouts"}
  assert fam["Hills"]["episodes"] == 4
  assert abs(fam["Hills"]["timeout_rate"] - 0.25) < 1e-9
  assert fam["Roundabouts"]["collision_rate"] == 1.0
  assert 0.0 < s["success_ci95"] < 1.0


def _assert_rows_match(got, want, distance_atol, keys=EPISODE_KEYS):
  assert list(got) == list(want)
  for task_id in want:
    eps_got = got[task_id].get("episodes", [got[task_id]])
    eps_want = want[task_id].get("episodes", [want[task_id]])
    assert len(eps_got) == len(eps_want)
    for g, w in zip(eps_got, eps_want):
      assert set(g) == set(w)
      for key in keys:
        if key == "distance":
          assert abs(g[key] - w[key]) <= distance_atol, (task_id, g, w)
        else:
          assert g[key] == w[key], (task_id, key, g, w)
          assert type(g[key]) is type(w[key]), (task_id, key)


@pytest.fixture(scope="module", params=[20, 200], ids=lambda h: "h%d" % h)
def autopilot_runs(request, tmp_path_factory):
  """The JAX package's multi-episode evaluation (horizon 20), and the same
  long enough for the heroes to drive through traffic (200 steps)."""
  out = tmp_path_factory.mktemp("autopilot")
  kwargs = dict(horizon=request.param, num_episodes=3, seed=5)
  want = jeval.evaluate_batched(TASKS, log_dir=str(out / "jax"), **kwargs)
  got = teval.evaluate_batched(TASKS, log_dir=str(out / "torch"),
                               device="cpu", **kwargs)
  return out, want, got


def test_evaluate_batched_autopilot_matches(autopilot_runs):
  _, want, got = autopilot_runs
  _assert_rows_match(got, want, DISTANCE_ATOL)
  assert all(len(row["episodes"]) == 3 for row in got.values())
  assert any(ep["distance"] > 1.0 for row in got.values()
             for ep in row["episodes"])


def test_evaluate_batched_writes_the_same_summary(autopilot_runs):
  out, _, _ = autopilot_runs
  with open(out / "jax" / "summary.json") as fp:
    want = json.load(fp)["summary"]
  with open(out / "torch" / "summary.json") as fp:
    got = json.load(fp)["summary"]

  def keys(d):
    return {k: keys(v) if isinstance(v, dict) else None
            for k, v in d.items()}

  assert keys(got) == keys(want)
  for fam in [None] + sorted(want["per_family"]):
    w = want if fam is None else want["per_family"][fam]
    g = got if fam is None else got["per_family"][fam]
    for key in ("episodes", "success_rate", "success_ci95",
                "collision_rate", "timeout_rate"):
      assert g[key] == w[key], (fam, key)
    assert abs(g["mean_distance"] - w["mean_distance"]) <= DISTANCE_ATOL
  for task_id in TASKS:
    with open(out / "torch" / task_id / "metrics.csv") as fp:
      header = fp.read().split("\n")[0]
    with open(out / "jax" / task_id / "metrics.csv") as fp:
      assert fp.read().split("\n")[0] == header


def test_evaluate_batched_defaults_to_cuda():
  if torch.cuda.is_available():
    pytest.skip("a CUDA device is present: the default is usable here")
  with pytest.raises(RuntimeError, match="device='cpu'"):
    teval.evaluate_batched(TASKS, horizon=1)


@pytest.fixture(scope="module")
def rip_trees():
  return [_jax_dim(seed) for seed in (0, 1)]


def _torch_rip_policy(rip_trees, algorithm):
  trees = [tree for _, tree in rip_trees]
  ensemble = stack_ensemble(convert.load_ensemble(
      [tmodels.ImitativeModel(device="cpu") for _ in trees], trees))
  return make_rip_policy(ensemble, algorithm=algorithm, num_plan_steps=2)


RIP_KWARGS = dict(horizon=8, num_episodes=2, seed=3)


def test_evaluate_batched_rip_wcm_matches(rip_trees):
  jm = rip_trees[0][0]
  stacked = jstack_ensemble([tree for _, tree in rip_trees])
  want = jeval.evaluate_batched(
      TASKS, policy_fn=jmake_rip_policy(jm, stacked, algorithm="WCM",
                                        num_plan_steps=2), **RIP_KWARGS)
  got = teval.evaluate_batched(
      TASKS, policy_fn=_torch_rip_policy(rip_trees, "WCM"), device="cpu",
      **RIP_KWARGS)
  _assert_rows_match(got, want, RIP_DISTANCE_ATOL,
                     keys=("steps", "collisions", "success", "distance"))


@pytest.mark.parametrize("algorithm", ["WCM", "MA", "BCM"])
def test_evaluate_batched_rip_schema(rip_trees, algorithm, tmp_path):
  """The summary schema and per-family decomposition of the JAX package's
  RIP evaluation test, for each aggregator."""
  out = str(tmp_path / "eval_{}".format(algorithm))
  results = teval.evaluate_batched(
      TASKS, policy_fn=_torch_rip_policy(rip_trees, algorithm), log_dir=out,
      device="cpu", **RIP_KWARGS)
  assert set(results) == set(TASKS)
  for row in results.values():
    assert len(row["episodes"]) == 2
  with open(os.path.join(out, "summary.json")) as fp:
    summary = json.load(fp)["summary"]
  for key in ("success_rate", "success_ci95", "collision_rate",
              "timeout_rate", "episodes", "per_family"):
    assert key in summary, (algorithm, key)
  assert summary["episodes"] == 4
  assert set(summary["per_family"]) == {"Town02_Straight", "Town02_Turn"}
  for fam in summary["per_family"].values():
    assert fam["episodes"] == 2
    for rate in ("success_rate", "collision_rate", "timeout_rate"):
      assert 0.0 <= fam[rate] <= 1.0


@pytest.mark.parametrize("agent", ["dim", "cil", "rip"])
def test_cli_learned_agents_need_a_checkpoint_loader(agent):
  # The loader exists (tests/test_torch_checkpoint.py drives it); without
  # a checkpoint to give it, the CLI refuses before building anything.
  flag = "--ckpts" if agent == "rip" else "--ckpt"
  with pytest.raises(ValueError, match="needs a checkpoint: " + flag):
    run.main(["--agent", agent, "--log_dir", "unused", "--cpu"])


def test_cli_rule_based_agents():
  parse = lambda *a: type("Args", (), dict(agent=a[0], noise=0.2))  # pylint: disable=unnecessary-lambda-assignment
  autopilot = run.make_agent_fn(parse("autopilot"))
  assert autopilot.keywords == {"noise": 0.2}
  assert run.make_agent_fn(parse("blind")).__name__ == "BlindAgent"


def test_jax_is_the_reference_here():
  # The tests above run the JAX package on the CPU, as its own tests do.
  assert jax.default_backend() == "cpu"
