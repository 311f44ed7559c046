"""``oatomobile_torch.experiments`` against the JAX package's experiment
scripts (``scripts/``) on the CPU, at a small size.

The JAX scripts read their knobs when imported, so each is imported with
``importlib`` after its environment is set; nothing of ``scripts/``
changes.  Held against them: the collection mix (the merged pack, with
the collection tests' tolerances), the train-in-the-loop round's
evaluation and ``history.json`` keys, and the publisher's tables (byte
for byte).  The training phase writes the best checkpoints and trains
nothing the second time; the checkpoints of either package load.  The
evaluation phase's tables are held against the JAX script's in
``tests/test_torch_experiments_eval.py``.
"""

import functools
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oatomobile_torch import models as tmodels
from oatomobile_torch.experiments import (eval_carnovel_agents, headtohead,
                                          pipeline, publish, round5,
                                          train_in_the_loop)
from oatomobile_torch.models import convert
from oatomobile_tpu import models as jmodels
from oatomobile_tpu.benchmarks import batched_eval as jeval
from oatomobile_tpu.benchmarks.carnovel import benchmark as jcarnovel
from oatomobile_tpu.envs import batched as jbatched
from oatomobile_tpu.utils.checkpoint import Checkpointer as JaxCheckpointer
from test_torch_benchmarks import RIP_DISTANCE_ATOL
from test_torch_datasets import read_pack
from test_torch_models import dim_context, random_tree
from test_torch_policies import _jax_dim
from torch_port_helpers import fraction_beyond

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The collection mix at a small size: 120 steps are the fewest that hold a
# window (20 past + 80 future steps).
MIX = [[0, 2], [8, 2]]
EP_STEPS, CHUNK = 120, 2
# The evaluation: two CARNOVEL tasks of one town and one CoRL2017 task.
CARNOVEL_TASKS = ("AbnormalTurns0-v0", "AbnormalTurns1-v0")
CORL_TASKS = ("Town02_Straight0-v0",)
HORIZON = 20
POLICIES = ["autopilot", "cil", "dim", "rip_wcm"]
K = 2
EPISODE_KEYS = ("steps", "collisions", "success", "distance")


def jax_script(name: str, env: dict):
  """``scripts/<name>.py`` imported afresh with ``env`` set."""
  with pytest.MonkeyPatch.context() as mp:
    for key, value in env.items():
      mp.setenv(key, str(value))
    spec = importlib.util.spec_from_file_location(
        "jax_" + name, os.path.join(ROOT, "scripts", name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
  return module


def assert_packs_match(got: dict, want: dict) -> None:
  """Packs with the collection tests' tolerances
  (``tests/test_torch_collect.py``): uint8 values apart by more than one
  count under 1e-4 of them (a rect-edge pixel may fall either side),
  floats within 1e-3."""
  assert got["manifest"] == want["manifest"]
  for key, a in want["arrays"].items():
    b = got["arrays"][key]
    assert a.shape == b.shape and a.dtype == b.dtype, key
    if a.dtype == np.uint8:
      assert fraction_beyond(b.astype(int), a.astype(int), 1) < 1e-4, key
    else:
      np.testing.assert_allclose(b, a, rtol=0, atol=1e-3, err_msg=key)


def _tasks(suite: dict, ids) -> dict:
  return {t: suite[t] for t in ids}


# -- collect and train --------------------------------------------------------------


@pytest.fixture(scope="module")
def packs(tmp_path_factory):
  """The merged pack of each package's collection phase."""
  out = {}
  for name in ("jax", "torch"):
    root = str(tmp_path_factory.mktemp("collect_" + name))
    packed = os.path.join(root, "packed")
    if name == "jax":
      jax_script("experiment_r4", dict(
          RUN_OUT=root, RUN_MIX=json.dumps(MIX), RUN_EP_STEPS=EP_STEPS,
          RUN_CHUNK=CHUNK)).collect(packed)
    else:
      pipeline.collect(packed, out=root, mix=MIX, ep_steps=EP_STEPS,
                       chunk=CHUNK, device="cpu")
    out[name] = packed
  return out


def test_collect_matches_jax(packs, capsys):
  got, want = read_pack(packs["torch"]), read_pack(packs["jax"])
  assert got["manifest"]["num_samples"] > 0
  assert_packs_match(got, want)
  assert got["arrays"]["lidar"].shape[1:3] == (100, 100)
  # Resumable: the pack exists, nothing is collected again.
  pipeline.collect(packs["torch"], out=os.path.dirname(packs["torch"]),
                   mix=MIX, ep_steps=EP_STEPS, chunk=CHUNK, device="cpu")
  assert "dataset exists" in capsys.readouterr().out
  assert_packs_match(read_pack(packs["torch"]), want)


def test_train_writes_best_checkpoints_once(packs, tmp_path, capsys):
  out = str(tmp_path)
  kwargs = dict(out=out, num_models=K, epochs=1, batch=8, accum=2,
                device="cpu")
  pipeline.train(packs["torch"], **kwargs)
  best = [os.path.join(out, "rip", "ckpts", "ensemble-best.pt"),
          os.path.join(out, "cil", "ckpts", "model-best.pt")]
  stamps = [os.path.getmtime(p) for p in best]
  members = pipeline.read_ensemble(os.path.join(out, "rip", "ckpts"),
                                   device="cpu")
  assert len(members) == K
  assert pipeline.read_cil(os.path.join(out, "cil", "ckpts"),
                           device="cpu").output_shape == (40, 2)
  capsys.readouterr()
  pipeline.train(packs["torch"], **kwargs)
  logged = capsys.readouterr().out
  assert "ensemble-best exists" in logged and "cil-best exists" in logged
  assert [os.path.getmtime(p) for p in best] == stamps


# -- evaluate on JAX-format checkpoints -------------------------------------------


@pytest.fixture(scope="module")
def trees():
  """Seeded flax trees: K DIM members and one CIL model."""
  dims = [_jax_dim(seed) for seed in range(K)]
  jm = jmodels.BehaviouralModel()
  ctx = dict(dim_context(1, 0), mode=np.zeros((1, 1), np.float32))
  cil = random_tree(jm, **{k: jnp.asarray(v) for k, v in ctx.items()})
  return {"dim": [tree for _, tree in dims], "dim_model": dims[0][0],
          "cil": cil}


def write_jax_checkpoints(out: str, trees) -> None:
  """The JAX trainers' best checkpoints (``.flax``) of ``trees``."""
  stacked = jax.tree.map(lambda *xs: np.stack(xs), *trees["dim"])
  JaxCheckpointer(os.path.join(out, "rip", "ckpts"),
                  prefix="ensemble").save_named("best", stacked)
  JaxCheckpointer(os.path.join(out, "cil", "ckpts")).save_named(
      "best", trees["cil"])


def test_policies_read_both_checkpoint_formats(tmp_path, trees):
  """The ``.flax`` ensemble and the same weights as the port's ``.pt``
  give the same members."""
  flax_dir, pt_dir = str(tmp_path / "flax"), str(tmp_path / "pt")
  write_jax_checkpoints(flax_dir, trees)
  members = pipeline.read_ensemble(os.path.join(flax_dir, "rip", "ckpts"),
                                   device="cpu")
  from oatomobile_torch.baselines.learned.rip.train import stack_params  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.utils.checkpoint import Checkpointer  # pylint: disable=import-outside-toplevel
  Checkpointer(os.path.join(pt_dir, "rip", "ckpts"),
               prefix="ensemble").save(3, stack_params(members))
  again = pipeline.read_ensemble(os.path.join(pt_dir, "rip", "ckpts"), 3,
                                 device="cpu")
  assert pipeline.latest_epoch(os.path.join(pt_dir, "rip", "ckpts"),
                               "ensemble") == 3
  for tree, a, b in zip(trees["dim"], members, again):
    want = convert.load(tmodels.ImitativeModel(device="cpu"), tree)
    for (name, p), q, r in zip(want.state_dict().items(),
                               a.state_dict().values(),
                               b.state_dict().values()):
      assert torch.equal(p, q) and torch.equal(p, r), name


# -- train in the loop ------------------------------------------------------------------


LOOP_SIZE = dict(rollout_scenes=2, rollout_steps=10, carnovel_horizon=10)


def test_loop_evaluation_matches_jax(trees):
  """The round's evaluation (the Town01 rollout and CARNOVEL) on converted
  weights against the JAX script's at the same size."""
  module = jax_script("train_in_the_loop", dict(LOOP_CARNOVEL_EPISODES=1))

  class SmallEnv(jbatched.BatchedEnv):

    def __init__(self, town, batch_size, **kwargs):
      del batch_size
      super().__init__(town, LOOP_SIZE["rollout_scenes"], **kwargs)

    def rollout(self, num_steps, **kwargs):
      del num_steps
      return super().rollout(LOOP_SIZE["rollout_steps"], **kwargs)

  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(jbatched, "BatchedEnv", SmallEnv)
    mp.setattr(jcarnovel, "_TASKS", _tasks(jcarnovel._TASKS, CARNOVEL_TASKS))
    mp.setattr(jeval, "evaluate_batched", functools.partial(
        jeval.evaluate_batched, horizon=LOOP_SIZE["carnovel_horizon"]))
    want = module.evaluate(trees["dim_model"], trees["dim"][0], seed=31)
  model = convert.load(tmodels.ImitativeModel(device="cpu"), trees["dim"][0])
  got = train_in_the_loop.evaluate(
      model, seed=31, carnovel_episodes=1,
      carnovel_tasks=_tasks(pipeline.suites()["carnovel"], CARNOVEL_TASKS),
      device="cpu", **LOOP_SIZE)
  assert set(got) == set(want)
  assert abs(got["town01_mean_distance_m"] -
             want["town01_mean_distance_m"]) <= RIP_DISTANCE_ATOL
  assert got["town01_mean_distance_m"] > 0
  for key in ("town01_collision_free", "carnovel_success",
              "carnovel_success_ci95", "carnovel_collision"):
    assert got[key] == want[key], key


def test_run_round_writes_history(tmp_path):
  out = str(tmp_path)
  result = train_in_the_loop.run_round(
      0, out=out, episodes=2, epochs=1, carnovel_episodes=1, num_steps=120,
      chunk_episodes=2, batch_size=8,
      carnovel_tasks=_tasks(pipeline.suites()["carnovel"], CARNOVEL_TASKS[:1]),
      device="cpu", **LOOP_SIZE)
  with open(os.path.join(out, "history.json")) as fp:
    history = json.load(fp)
  assert history == [result]
  assert set(result) == {
      "town01_mean_distance_m", "town01_collision_free", "carnovel_success",
      "carnovel_success_ci95", "carnovel_collision", "round", "samples"}
  assert result["round"] == 0 and result["samples"] > 0
  for key in ("town01_collision_free", "carnovel_success",
              "carnovel_collision"):
    assert 0.0 <= result[key] <= 1.0
  assert os.path.exists(os.path.join(out, "dim", "ckpts", "model-0.pt"))


def test_plot_curve_matches_jax(tmp_path):
  """The rounds' curve: the same PNG as the JAX script's for one history."""
  module = jax_script("train_in_the_loop", {})
  history = [{"round": i, "carnovel_success": 0.1 * i,
              "carnovel_success_ci95": 0.05, "town01_collision_free": 0.9}
             for i in range(3)]
  paths = [str(tmp_path / name) for name in ("torch.png", "jax.png")]
  train_in_the_loop.plot_curve(history, paths[0])
  module.plot_curve(history, paths[1])
  with open(paths[0], "rb") as got, open(paths[1], "rb") as want:
    assert got.read() == want.read()


# -- publish --------------------------------------------------------------------------


def _summary(rs, families):
  rates = rs.dirichlet(np.ones(3))
  return {"success_rate": float(rates[0]), "collision_rate": float(rates[1]),
          "timeout_rate": float(rates[2]), "success_ci95": float(rs.rand()),
          "episodes": int(rs.randint(1, 500)), "mean_distance": 1.0,
          "per_family": {f: {"success_rate": float(rs.rand()),
                             "collision_rate": float(rs.rand()),
                             "timeout_rate": float(rs.rand()),
                             "success_ci95": float(rs.rand())}
                         for f in families}}


def test_publish_renders_the_jax_tables(tmp_path):
  jpub = jax_script("post_experiment_r5", dict(RUN_OUT=str(tmp_path)))
  rs = np.random.RandomState(0)
  tables = {"carnovel": {n: _summary(rs, ["Hills", "BusyTown"])
                         for n in publish.ORDER},
            "corl2017": {n: _summary(rs, ["Town01_FullTown"])
                         for n in ("autopilot", "rip_wcm", "dim", "cil")}}
  out = str(tmp_path / "run")
  os.makedirs(out)
  for suite, name, tasks in (("carnovel", "rip_wcm", 27),
                             ("corl2017", "dim", 150)):
    tables[suite][name]["episodes"] = 3 * tasks
    os.makedirs(os.path.join(out, "{}_{}".format(suite, name)))
    with open(os.path.join(out, "{}_{}".format(suite, name),
                           "summary.json"), "w") as fp:
      json.dump({"summary": tables[suite][name],
                 "tasks": {str(t): {} for t in range(tasks)}}, fp)
  with open(os.path.join(out, "tables.json"), "w") as fp:
    json.dump(tables, fp)
  path = publish.publish(out, horizon=64)
  assert os.path.dirname(path) == os.path.join(out, "results")
  with open(path) as fp:
    md = fp.read()
  blocks = [
      jpub.render_table("CARNOVEL (distribution shift, Towns 03-05)",
                        tables["carnovel"]),
      jpub.render_families("CARNOVEL (RIP-WCM)",
                           tables["carnovel"]["rip_wcm"]["per_family"]),
      jpub.render_table("CoRL2017 (in-distribution, Towns 01-02)",
                        tables["corl2017"]),
      jpub.render_families("CoRL2017 (DIM)",
                           tables["corl2017"]["dim"]["per_family"]),
  ]
  assert md.endswith("\n".join(blocks))
  assert publish.FIDELITY_CAVEAT == jpub.FIDELITY_CAVEAT
  assert md.startswith("# Agent results\n\n" + jpub.FIDELITY_CAVEAT)
  assert ("CARNOVEL 3 episodes/task, CoRL2017 3 episodes/task, the "
          "horizon cut to 64 steps") in md
  for x, ci in ((0.0, None), (0.4567, 0.0123), (1.0, 0.5)):
    assert publish.fmt_pct(x, ci) == jpub.fmt_pct(x, ci)
  assert sorted(os.listdir(os.path.join(out, "results"))) == [
      "RESULTS.md", "carnovel_rip_wcm.json", "corl2017_dim.json",
      "tables.json"]
  # Nothing outside the run's directory.
  assert sorted(os.listdir(str(tmp_path))) == ["run"]


# -- the command lines ------------------------------------------------------------------


def test_experiments_default_to_the_card(tmp_path, monkeypatch):
  if torch.cuda.is_available():
    pytest.skip("a CUDA device is present: the default is usable here")
  monkeypatch.setenv("RUN_OUT", str(tmp_path / "run"))
  monkeypatch.setenv("LOOP_OUT", str(tmp_path / "loop"))
  monkeypatch.setenv("LOOP_ROUNDS", "1")
  for name, value in round5.DEFAULTS.items():  # round5 sets what is unset
    monkeypatch.setenv(name, os.environ.get(name, value))
  monkeypatch.setenv("RUN_OUT", str(tmp_path / "run"))
  for main in (pipeline.main, round5.main, train_in_the_loop.main):
    with pytest.raises(RuntimeError, match="device='cpu'"):
      main([])
  assert round5.DEFAULTS["RUN_EPOCHS"] == "30"
  assert headtohead.EPISODES == 20 and headtohead.SEED == 11
  assert callable(eval_carnovel_agents.run)
