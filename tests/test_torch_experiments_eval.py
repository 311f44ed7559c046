"""The evaluation phase of ``oatomobile_torch.experiments.pipeline``
against the JAX package's ``scripts/experiment_r4.py`` on the CPU: both
scripts evaluate the autopilot, CIL, DIM and RIP-WCM from the same
JAX-format checkpoints of seeded weights (K = 2) on two CARNOVEL tasks
and one CoRL2017 task, one episode each, at a 20-step horizon (the JAX
side restricted with ``monkeypatch`` on its suites' ``_TASKS`` and on
``evaluate_batched``'s horizon).  The tables must match: per-episode
steps, collisions and success equal, distances within the evaluator
tests' limits; a second run reads the summaries and runs nothing.
"""

import functools
import json
import os

import pytest
import torch

from oatomobile_torch.experiments import pipeline
from oatomobile_tpu.benchmarks import batched_eval as jeval
from oatomobile_tpu.benchmarks.carnovel import benchmark as jcarnovel
from oatomobile_tpu.benchmarks.corl2017 import benchmark as jcorl
from test_torch_benchmarks import (DISTANCE_ATOL, RIP_DISTANCE_ATOL,
                                   _assert_rows_match)
from test_torch_experiments import (CARNOVEL_TASKS, CORL_TASKS,
                                    EPISODE_KEYS, HORIZON, K, POLICIES,
                                    _tasks, jax_script, trees,  # pylint: disable=unused-import
                                    write_jax_checkpoints)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def evaluations(tmp_path_factory, trees):
  """Each package's evaluation phase over the same checkpoints and tasks:
  (its output directory, the tables it returned or wrote)."""
  roots = {name: str(tmp_path_factory.mktemp("eval_" + name))
           for name in ("jax", "torch")}
  for root in roots.values():
    write_jax_checkpoints(root, trees)
  names = ",".join(POLICIES)
  module = jax_script("experiment_r4", dict(
      RUN_OUT=roots["jax"], RUN_NUM_MODELS=K, RUN_EPISODES=1,
      RUN_CORL_EPISODES=1, RUN_POLICIES=names, RUN_CORL_POLICIES=names))
  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(jcarnovel, "_TASKS", _tasks(jcarnovel._TASKS, CARNOVEL_TASKS))
    mp.setattr(jcorl, "_TASKS", _tasks(jcorl._TASKS, CORL_TASKS))
    mp.setattr(jeval, "evaluate_batched",
               functools.partial(jeval.evaluate_batched, horizon=HORIZON))
    module.evaluate()
  suites = pipeline.suites()
  got = pipeline.evaluate(
      out=roots["torch"], carnovel_policies=POLICIES, corl_policies=POLICIES,
      episodes=1, corl_episodes=1, num_models=K, horizon=HORIZON,
      carnovel_tasks=_tasks(suites["carnovel"], CARNOVEL_TASKS),
      corl_tasks=_tasks(suites["corl2017"], CORL_TASKS), device="cpu")
  with open(os.path.join(roots["jax"], "tables.json")) as fp:
    want = json.load(fp)
  return roots, got, want


def test_evaluate_tables_match_jax(evaluations):
  roots, got, want = evaluations
  with open(os.path.join(roots["torch"], "tables.json")) as fp:
    assert json.load(fp) == got
  assert sorted(got) == sorted(want) == ["carnovel", "corl2017"]
  for suite in want:
    assert list(got[suite]) == list(want[suite]) == POLICIES
    for name in POLICIES:
      atol = DISTANCE_ATOL if name == "autopilot" else RIP_DISTANCE_ATOL
      key = "{}_{}".format(suite, name)
      rows = {}
      for side, root in roots.items():
        with open(os.path.join(root, key, "summary.json")) as fp:
          rows[side] = json.load(fp)["tasks"]
      _assert_rows_match(rows["torch"], rows["jax"], atol, keys=EPISODE_KEYS)
      g, w = got[suite][name], want[suite][name]
      assert set(g) == set(w)
      for field in ("episodes", "success_rate", "success_ci95",
                    "collision_rate", "timeout_rate"):
        assert g[field] == w[field], (key, field)
      assert abs(g["mean_distance"] - w["mean_distance"]) <= atol
      for task in rows["torch"]:
        assert os.path.exists(os.path.join(roots["torch"], key, task,
                                           "metrics.csv"))


def test_evaluate_resumes_from_the_summaries(evaluations, capsys):
  roots, got, _ = evaluations
  suites = pipeline.suites()
  again = pipeline.evaluate(
      out=roots["torch"], carnovel_policies=POLICIES, corl_policies=POLICIES,
      episodes=1, corl_episodes=1, num_models=K, horizon=HORIZON,
      carnovel_tasks=_tasks(suites["carnovel"], CARNOVEL_TASKS),
      corl_tasks=_tasks(suites["corl2017"], CORL_TASKS), device="cpu")
  assert again == got
  assert "evaluating" not in capsys.readouterr().out




def test_carnovel_agents_and_headtohead_run(tmp_path, trees, monkeypatch):  # pylint: disable=redefined-outer-name
  """The CARNOVEL agent comparison (from the newest epoch of a JAX-format
  ensemble, K from the file) and the head-to-head, at two steps on one
  task: each writes its summaries in the evaluator's schema."""
  import jax  # pylint: disable=import-outside-toplevel
  import numpy as np  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.experiments import (eval_carnovel_agents,  # pylint: disable=import-outside-toplevel
                                            headtohead)
  from oatomobile_tpu.utils.checkpoint import Checkpointer  # pylint: disable=import-outside-toplevel
  out = str(tmp_path)
  write_jax_checkpoints(out, trees)
  stacked = jax.tree.map(lambda *xs: np.stack(xs), *trees["dim"])
  ckpt = Checkpointer(os.path.join(out, "rip", "ckpts"), prefix="ensemble")
  for epoch in (1, 3):
    ckpt.save(epoch, stacked)
  tasks = _tasks(pipeline.suites()["carnovel"], CARNOVEL_TASKS[:1])
  table = eval_carnovel_agents.run(out, horizon=2, tasks=tasks, device="cpu")
  with open(os.path.join(out, "agents_summary.json")) as fp:
    assert json.load(fp) == table
  assert list(table) == ["autopilot", "dim", "rip_wcm", "rip_ma"]
  for summary in table.values():
    assert summary["episodes"] == 1
  monkeypatch.setenv("RUN_NUM_MODELS", str(K))  # the pipeline's knob
  headtohead.run(out=out, horizon=2, tasks=tasks, device="cpu")
  for name in ("rip_wcm", "dim"):
    with open(os.path.join(out, "carnovel20_" + name, "summary.json")) as fp:
      assert json.load(fp)["summary"]["episodes"] == headtohead.EPISODES
