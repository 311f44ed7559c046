"""``oatomobile_torch.experiments.study_dim50`` against the JAX package's
``scripts/study_dim50.py`` on the CPU.  Both start from the same
JAX-format best checkpoint of a seeded 50x50 DIM and the same training
log, so neither trains, and both evaluate it on two CARNOVEL tasks, two
episodes each, at a 10-step horizon (the JAX side restricted with
``monkeypatch``): ``dim50_study.json`` must be equal, and each episode
within the evaluator tests' RIP limits.  Then the port trains the study's
DIM for one epoch on a small pack and writes the same layout; a second run
trains nothing.
"""

import functools
import json
import os

import jax.numpy as jnp
import pytest
import torch

from oatomobile_torch.datasets.carla import CARLADataset
from oatomobile_torch.experiments import pipeline, study_dim50
from oatomobile_tpu import models as jmodels
from oatomobile_tpu.benchmarks import batched_eval as jeval
from oatomobile_tpu.benchmarks.carnovel import benchmark as jcarnovel
from oatomobile_tpu.utils.checkpoint import Checkpointer as JaxCheckpointer
from test_torch_benchmarks import RIP_DISTANCE_ATOL, _assert_rows_match
from test_torch_experiments import _tasks, jax_script
from test_torch_models import dim_context, random_tree

torch.set_num_threads(1)

TASKS = ("AbnormalTurns0-v0", "AbnormalTurns1-v0")
HORIZON, EPISODES = 10, 2
VAL_LOSSES = (5.0, 3.25, 4.0)


def write_trained(out: str, tree) -> None:
  """A JAX trainer's best checkpoint and log under ``out/dim50``."""
  JaxCheckpointer(os.path.join(out, "dim50", "ckpts")).save_named("best",
                                                                   tree)
  os.makedirs(os.path.join(out, "dim50", "logs"))
  with open(os.path.join(out, "dim50", "logs", "dim_train.jsonl"),
            "w") as fp:
    for epoch, val in enumerate(VAL_LOSSES):
      fp.write(json.dumps({"epoch": epoch, "loss": 1.0, "val_loss": val})
               + "\n")


def test_study_matches_jax_on_the_same_weights(tmp_path):
  jm = jmodels.ImitativeModel((4, 2), study_dim50.INPUT_SIZE)
  ctx = {k: jnp.zeros((1,) + v.shape[1:])
         for k, v in dim_context(1, 0, size=50).items()}
  tree = random_tree(jm, jnp.zeros((1, 4, 2)), method=jm.log_prob, seed=3,
                     **ctx)
  roots = {side: str(tmp_path / side) for side in ("jax", "torch")}
  for root in roots.values():
    write_trained(root, tree)
  module = jax_script("study_dim50", dict(RUN_OUT=roots["jax"],
                                          STUDY_EPISODES=EPISODES))
  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(jcarnovel, "_TASKS", _tasks(jcarnovel._TASKS, TASKS))
    mp.setattr(jeval, "evaluate_batched",
               functools.partial(jeval.evaluate_batched, horizon=HORIZON))
    module.main()
  got = study_dim50.run(out=roots["torch"], episodes=EPISODES,
                        horizon=HORIZON, device="cpu",
                        tasks=_tasks(pipeline.suites()["carnovel"], TASKS))
  with open(os.path.join(roots["jax"], "dim50_study.json")) as fp:
    want = json.load(fp)
  with open(os.path.join(roots["torch"], "dim50_study.json")) as fp:
    assert json.load(fp) == got
  assert got == want
  assert got["best_val_nll"] == min(VAL_LOSSES)
  assert got["carnovel"]["episodes"] == EPISODES * len(TASKS)
  rows = {}
  for side, root in roots.items():
    with open(os.path.join(root, "carnovel_dim50", "summary.json")) as fp:
      rows[side] = json.load(fp)["tasks"]
  _assert_rows_match(rows["torch"], rows["jax"], RIP_DISTANCE_ATOL,
                     keys=("steps", "collisions", "success", "distance"))


def test_study_trains_one_epoch_then_resumes(tmp_path, capsys):
  out = str(tmp_path)
  n = CARLADataset.collect_packed("Town02", os.path.join(out, "packed"),
                                  num_episodes=2, num_steps=200, seed=21,
                                  device="cpu")
  assert n >= 8
  kwargs = dict(out=out, epochs=1, episodes=1, horizon=2, batch=4,
                tasks=_tasks(pipeline.suites()["carnovel"], TASKS[:1]),
                device="cpu")
  result = study_dim50.run(**kwargs)
  assert list(result) == ["carnovel", "best_val_nll"]
  assert list(result["carnovel"]) == list(study_dim50.SUMMARY_KEYS)
  assert result["carnovel"]["episodes"] == 1
  records = pipeline.train_log(os.path.join(out, "dim50"))
  assert len(records) == 1 and result["best_val_nll"] == records[0][
      "val_loss"]
  best = os.path.join(out, "dim50", "ckpts", "model-best.pt")
  stamp = os.path.getmtime(best)
  capsys.readouterr()
  assert study_dim50.run(**kwargs) == result
  assert "train DIM" not in capsys.readouterr().out
  assert os.path.getmtime(best) == stamp
