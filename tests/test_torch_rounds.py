"""``oatomobile_torch.experiments.{round2, post_round2, round3}`` against
the JAX package's ``scripts/experiment_r2.py``, ``post_experiment.py`` and
``experiment_r3.py`` on the CPU, at a small size.

The JAX scripts read their knobs when imported: each is imported with
``importlib`` after its environment is set (``jax_script``); nothing of
``scripts/`` changes.  The JAX round-2 evaluation has no horizon or task
knob: the test restricts it with ``monkeypatch`` on its suite's
``_TASKS`` and on ``evaluate_batched``'s horizon, for the call only.

Held: round 2's collection (a pack at the sensors' 200x200, with the
collection tests' tolerances), its training log line, its evaluation's
rows from the same JAX-format checkpoint (K = 4: per-episode steps,
collisions and success equal, distances within the learned evaluator
tests' 1e-2 m), the re-run of every policy and the fallback to the
newest epoch; ``post_round2``'s four steps in the JAX order; round 3's
knobs against the JAX script's module constants.
"""

import functools
import json
import os
import re
import subprocess

import jax
import numpy as np
import pytest
import torch

from oatomobile_torch.experiments import (pipeline, post_round2, round2,
                                          round3)
from oatomobile_tpu.benchmarks import batched_eval as jeval
from oatomobile_tpu.benchmarks.carnovel import benchmark as jcarnovel
from oatomobile_tpu.utils.checkpoint import Checkpointer as JaxCheckpointer
from test_torch_benchmarks import RIP_DISTANCE_ATOL, _assert_rows_match
from test_torch_datasets import read_pack
from test_torch_experiments import (CARNOVEL_TASKS, EPISODE_KEYS, _tasks,
                                    assert_packs_match, jax_script)
from test_torch_policies import _jax_dim

torch.set_num_threads(1)

# Two densities of two episodes, 120 steps: the fewest that hold a window.
MIX = [[0, 2], [2, 2]]
EP_STEPS = 120
HORIZON = 8
POLICIES = ["dim", "rip_bcm"]
RUN_KNOBS = ("RUN_OUT", "RUN_EP_STEPS", "RUN_NOISE", "RUN_EPOCHS",
             "RUN_BATCH", "RUN_NUM_MODELS", "RUN_ACCUM", "RUN_EPISODES",
             "RUN_CORL_EPISODES", "RUN_MIX", "RUN_CHUNK", "RUN_BRIDGE",
             "RUN_POLICIES", "RUN_CORL_POLICIES", "RUN_TABLES", "RUN_HORIZON")


@pytest.fixture
def clean_env(monkeypatch):
  """The RUN_* knobs unset; whatever a test sets (a round's ``main`` sets
  its defaults) is undone after it."""
  for name in RUN_KNOBS:
    monkeypatch.setenv(name, "")
    monkeypatch.delenv(name)
  return monkeypatch


# -- collect and train ---------------------------------------------------------


@pytest.fixture(scope="module")
def packs(tmp_path_factory):
  """The merged pack of each package's round-2 collection."""
  out = {}
  for name in ("jax", "torch"):
    root = str(tmp_path_factory.mktemp("r2_" + name))
    packed = os.path.join(root, "packed")
    if name == "jax":
      jax_script("experiment_r2", dict(
          RUN_OUT=root, RUN_MIX=json.dumps(MIX),
          RUN_EP_STEPS=EP_STEPS)).collect(packed)
    else:
      round2.collect(packed, out=root, mix=MIX, ep_steps=EP_STEPS,
                     device="cpu")
    out[name] = packed
  return out


def test_collect_matches_jax_at_the_sensors_size(packs):
  got, want = read_pack(packs["torch"]), read_pack(packs["jax"])
  assert got["manifest"]["num_samples"] > 0
  assert got["arrays"]["lidar"].shape[1:] == (200, 200, 2)
  assert_packs_match(got, want)


def test_train_writes_best_and_logs_the_jax_line(packs, tmp_path, capsys):
  out = str(tmp_path)
  round2.train(packs["torch"], out=out, epochs=1, batch=8, device="cpu")
  ckpts = os.path.join(out, "rip", "ckpts")
  assert pipeline.has_best(ckpts, "ensemble")
  assert len(pipeline.read_ensemble(ckpts, device="cpu")) == round2.NUM_MODELS
  records = pipeline.train_log(os.path.join(out, "rip"), "rip")
  logged = capsys.readouterr().out
  assert "[r2 " in logged and "train RIP K=4, 1 epochs, batch 8" in logged
  line = re.search(r"train loss: (\S+) -> (\S+); best val (\S+)", logged)
  assert line, logged
  assert [float(x) for x in line.groups()] == [
      round(records[0]["loss"], 2), round(records[-1]["loss"], 2),
      round(min(r.get("val_loss", float("inf")) for r in records), 2)]
  round2.train(packs["torch"], out=out, epochs=1, batch=8, device="cpu")
  assert "ensemble-best exists" in capsys.readouterr().out


# -- evaluate ------------------------------------------------------------------


@pytest.fixture(scope="module")
def members():
  """Four seeded flax DIM trees (round 2's ensemble is K = 4)."""
  return [_jax_dim(seed)[1] for seed in range(round2.NUM_MODELS)]


def _write_best(out: str, trees) -> None:
  stacked = jax.tree.map(lambda *xs: np.stack(xs), *trees)
  JaxCheckpointer(os.path.join(out, "rip", "ckpts"),
                  prefix="ensemble").save_named("best", stacked)


@pytest.fixture(scope="module")
def evaluations(tmp_path_factory, members):
  """Each package's round-2 evaluation of POLICIES from the same
  JAX-format ``ensemble-best`` on two CARNOVEL tasks at HORIZON steps."""
  roots = {name: str(tmp_path_factory.mktemp("r2eval_" + name))
           for name in ("jax", "torch")}
  for root in roots.values():
    _write_best(root, members)
  module = jax_script("experiment_r2", dict(
      RUN_OUT=roots["jax"], RUN_POLICIES=",".join(POLICIES)))
  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(jcarnovel, "_TASKS", _tasks(jcarnovel._TASKS, CARNOVEL_TASKS))
    mp.setattr(jeval, "evaluate_batched",
               functools.partial(jeval.evaluate_batched, horizon=HORIZON))
    module.evaluate()
  got = round2.evaluate(
      out=roots["torch"], policies=POLICIES, horizon=HORIZON,
      tasks=_tasks(pipeline.suites()["carnovel"], CARNOVEL_TASKS),
      device="cpu")
  with open(os.path.join(roots["jax"], "agents_summary.json")) as fp:
    want = json.load(fp)
  return roots, got, want


def test_evaluate_rows_match_jax(evaluations):
  roots, got, want = evaluations
  with open(os.path.join(roots["torch"], "agents_summary.json")) as fp:
    assert json.load(fp) == got
  assert list(got) == list(want) == POLICIES
  for name in POLICIES:
    rows = {}
    for side, root in roots.items():
      with open(os.path.join(root, "carnovel_" + name,
                             "summary.json")) as fp:
        rows[side] = json.load(fp)["tasks"]
    _assert_rows_match(rows["torch"], rows["jax"], RIP_DISTANCE_ATOL,
                       keys=EPISODE_KEYS)
    g, w = got[name], want[name]
    assert set(g) == set(w)
    for field in ("episodes", "success_rate", "success_ci95",
                  "collision_rate", "timeout_rate"):
      assert g[field] == w[field], (name, field)
    assert abs(g["mean_distance"] - w["mean_distance"]) <= RIP_DISTANCE_ATOL


def test_evaluate_runs_every_policy_again(evaluations, capsys):
  roots, got, _ = evaluations
  summary = os.path.join(roots["torch"], "carnovel_dim", "summary.json")
  stamp = os.path.getmtime(summary)
  again = round2.evaluate(
      out=roots["torch"], policies=["dim"], horizon=HORIZON,
      tasks=_tasks(pipeline.suites()["carnovel"], CARNOVEL_TASKS),
      device="cpu")
  logged = capsys.readouterr().out
  assert "loaded ensemble-best" in logged and "evaluating dim" in logged
  assert os.path.getmtime(summary) > stamp
  # The row is replaced, the other rows kept.
  assert list(again) == POLICIES and again == got


def test_members_fall_back_to_the_newest_epoch(tmp_path, members, capsys):
  from oatomobile_torch.baselines.learned.rip.train import stack_params  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.utils.checkpoint import Checkpointer  # pylint: disable=import-outside-toplevel
  best = str(tmp_path / "best")
  _write_best(best, members)
  want = pipeline.read_ensemble(os.path.join(best, "rip", "ckpts"),
                                device="cpu")
  ckpts = str(tmp_path / "rip" / "ckpts")
  saver = Checkpointer(ckpts, prefix="ensemble")
  saver.save(1, stack_params(want[::-1]))
  saver.save(3, stack_params(want))
  got = round2.read_members(ckpts, device="cpu")
  assert "loaded ensemble epoch 3" in capsys.readouterr().out
  for a, b in zip(got, want):
    for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
      assert torch.equal(x, y), name
  with pytest.raises(FileNotFoundError):
    round2.read_members(str(tmp_path / "none"), device="cpu")


# -- post_round2 -----------------------------------------------------------------


def test_post_round2_runs_the_four_steps_in_order(tmp_path, monkeypatch):
  """``subprocess.run`` recorded: round 2 with RUN_POLICIES=rip_bcm, then
  the CoRL2017 autopilot row (in this process), the flow profile and the
  bench, each with ``--cpu``; the bench runs for real at 2 scenes x 4
  steps and prints its JSON line."""
  out = str(tmp_path)
  corl = os.path.join(out, "corl2017_autopilot", "summary.json")
  calls = []
  real_run = subprocess.run

  def record(command, env=None, check=False, **kwargs):
    calls.append((command[1:], env, os.path.exists(corl)))
    assert check, command
    if command[2] == "oatomobile_torch.bench":
      proc = real_run(command, env=env, check=True, capture_output=True,
                      text=True, timeout=300)
      calls[-1] += (proc.stdout,)
    return subprocess.CompletedProcess(command, 0)

  monkeypatch.setattr(post_round2.subprocess, "run", record)
  monkeypatch.setenv("BENCH_BATCH", "2")
  monkeypatch.setenv("BENCH_STEPS", "4")
  monkeypatch.setenv("BENCH_TOWN", "Town02")
  monkeypatch.setenv("OMP_NUM_THREADS", "1")
  monkeypatch.setenv("RUN_POLICIES", "autopilot,dim")
  tasks = dict(list(pipeline.suites()["corl2017"].items())[:2])
  post_round2.run(out=out, horizon=4, corl_tasks=tasks, device="cpu")
  assert [c[0] for c in calls] == [
      ["-m", "oatomobile_torch.experiments.round2", "--cpu"],
      ["-m", "oatomobile_torch.experiments.profile_flow", "--cpu"],
      ["-m", "oatomobile_torch.bench", "--cpu"]]
  assert calls[0][1]["RUN_POLICIES"] == "rip_bcm"
  assert all(c[1]["RUN_OUT"] == out for c in calls)
  assert all(c[1]["RUN_POLICIES"] == "autopilot,dim" for c in calls[1:])
  # The CoRL2017 row ran between the round and the profile.
  assert [c[2] for c in calls] == [False, True, True]
  with open(corl) as fp:
    summary = json.load(fp)
  assert summary["summary"]["episodes"] == 2
  line = json.loads(calls[2][3].strip().splitlines()[-1])
  assert line["metric"] == "env_steps_per_sec_per_chip_1024bev"
  assert line["value"] > 0


def test_a_failed_step_fails_the_run(tmp_path, monkeypatch):
  def fail(command, **kwargs):
    raise subprocess.CalledProcessError(1, command)

  monkeypatch.setattr(post_round2.subprocess, "run", fail)
  with pytest.raises(subprocess.CalledProcessError):
    post_round2.run(out=str(tmp_path), device="cpu")
  assert not os.path.exists(os.path.join(str(tmp_path), "corl2017_autopilot"))


# -- knobs and defaults -----------------------------------------------------------


def _jax_knobs(module) -> dict:
  return dict(ep_steps=module.EP_STEPS, noise=module.NOISE,
              epochs=module.EPOCHS, batch=module.BATCH, mix=module.MIX,
              bridge=module.BRIDGE)


def test_round2_knobs_match_the_jax_script(clean_env):
  del clean_env
  module = jax_script("experiment_r2", {})
  k = round2.knobs()
  for name, value in _jax_knobs(module).items():
    assert getattr(k, name) == value, name
  assert k.policies == module.POLICIES
  assert k.out == pipeline.default_out("r2")
  assert k.horizon == pipeline.HORIZON


def test_round3_knobs_match_the_jax_script(clean_env):
  module = jax_script("experiment_r3", {})
  k = round3.knobs()
  want = dict(_jax_knobs(module), num_models=module.NUM_MODELS,
              accum=module.ACCUM, episodes=module.EPISODES,
              corl_episodes=module.CORL_EPISODES, chunk=module.CHUNK,
              policies=module.CARNOVEL_POLICIES,
              corl_policies=module.CORL_POLICIES, tables=module.TABLES)
  for name, value in want.items():
    assert getattr(k, name) == value, name
  assert k.out == pipeline.default_out("r3")
  # The environment wins over the round's defaults.
  clean_env.setenv("RUN_MIX", "[[1, 2]]")
  assert round3.knobs().mix == [[1, 2]]


def test_round3_runs_the_pipeline_with_its_defaults_and_tag(clean_env,
                                                            capsys):
  """``round3.main`` runs ``pipeline``'s three phases with round 3's
  defaults in the environment and its log tag; the tag is ``r4`` after."""
  seen = []

  def phase(name):
    def run(*args, **kwargs):
      seen.append((name, kwargs["device"], pipeline.knobs().mix))
      pipeline.log(name)
    return run

  for name in ("collect", "train", "evaluate"):
    clean_env.setattr(pipeline, name, phase(name))
  clean_env.setenv("RUN_OUT", os.path.join(pipeline.default_out("r3"),
                                           "tag_test"))
  round3.main(["--cpu"])
  mix = json.loads(round3.DEFAULTS["RUN_MIX"])
  assert seen == [(n, "cpu", mix) for n in ("collect", "train", "evaluate")]
  lines = capsys.readouterr().out.splitlines()
  assert [line.split(" ")[0] for line in lines] == ["[r3"] * 3
  pipeline.log("after")
  assert capsys.readouterr().out.startswith("[r4 ")


def test_rounds_default_to_the_card(tmp_path, clean_env):
  if torch.cuda.is_available():
    pytest.skip("a CUDA device is present: the default is usable here")
  clean_env.setenv("RUN_OUT", str(tmp_path))
  for main in (round2.main, round3.main, post_round2.main):
    with pytest.raises(RuntimeError, match="device='cpu'"):
      main([])
