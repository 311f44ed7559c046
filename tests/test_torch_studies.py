"""``oatomobile_torch.experiments.rip_sweep`` against the JAX package's
``scripts/eval_rip_sweep.py`` on the CPU: both sweep DIM (member 0) and
RIP-WCM at 2 plan steps over the same JAX-format ensemble of seeded
weights (K = 2) on two CARNOVEL tasks at a 10-step horizon (the JAX side
restricted with ``monkeypatch`` on its suite's ``_TASKS`` and on
``evaluate_batched``'s horizon, as ``tests/test_torch_experiments_eval.py``
does).  ``rip_sweep.json`` must match the JAX layout key for key and
value for value but the mean distance, which is held within the
evaluator tests' RIP limit, as is each episode; a second run evaluates
nothing again.
"""

import copy
import functools
import json
import os

import jax
import numpy as np
import pytest
import torch

from oatomobile_torch.experiments import pipeline, rip_sweep
from oatomobile_tpu.benchmarks import batched_eval as jeval
from oatomobile_tpu.benchmarks.carnovel import benchmark as jcarnovel
from oatomobile_tpu.utils.checkpoint import Checkpointer as JaxCheckpointer
from test_torch_benchmarks import RIP_DISTANCE_ATOL, _assert_rows_match
from test_torch_experiments import _tasks, jax_script
from test_torch_policies import _jax_dim

torch.set_num_threads(1)

K = 2
VARIANTS = [["dim", 2], ["rip_wcm", 2]]
TASKS = ("AbnormalTurns0-v0", "AbnormalTurns1-v0")
HORIZON = 10


def write_ensemble(out: str, trees) -> None:
  stacked = jax.tree.map(lambda *xs: np.stack(xs), *trees)
  JaxCheckpointer(os.path.join(out, "rip", "ckpts"),
                  prefix="ensemble").save_named("best", stacked)


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
  """Each package's sweep: (its output directory, its table)."""
  trees = [tree for _, tree in (_jax_dim(seed) for seed in range(K))]
  roots = {name: str(tmp_path_factory.mktemp("sweep_" + name))
           for name in ("jax", "torch")}
  for root in roots.values():
    write_ensemble(root, trees)
  module = jax_script("eval_rip_sweep", dict(
      RUN_OUT=roots["jax"], RUN_NUM_MODELS=K,
      RUN_VARIANTS=json.dumps(VARIANTS)))
  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(jcarnovel, "_TASKS", _tasks(jcarnovel._TASKS, TASKS))
    mp.setattr(jeval, "evaluate_batched",
               functools.partial(jeval.evaluate_batched, horizon=HORIZON))
    module.main()
  with open(os.path.join(roots["jax"], "rip_sweep.json")) as fp:
    want = json.load(fp)
  got = rip_sweep.run(out=roots["torch"], variants=VARIANTS, num_models=K,
                      horizon=HORIZON, device="cpu",
                      tasks=_tasks(pipeline.suites()["carnovel"], TASKS))
  return roots, got, want


def test_sweep_matches_jax(sweeps):  # pylint: disable=redefined-outer-name
  roots, got, want = sweeps
  with open(os.path.join(roots["torch"], "rip_sweep.json")) as fp:
    assert json.load(fp) == got
  assert list(got) == list(want) == ["dim_2steps", "rip_wcm_2steps"]
  for key in want:
    g, w = copy.deepcopy(got[key]), copy.deepcopy(want[key])
    assert list(g) == list(w)
    assert abs(g.pop("mean_distance") - w.pop("mean_distance")) <= \
        RIP_DISTANCE_ATOL
    for family in w["per_family"]:
      assert abs(g["per_family"][family].pop("mean_distance") -
                 w["per_family"][family].pop("mean_distance")) <= \
          RIP_DISTANCE_ATOL
    assert g == w, key
    rows = {}
    for side, root in roots.items():
      with open(os.path.join(root, "carnovel_" + key, "summary.json")) as fp:
        rows[side] = json.load(fp)["tasks"]
    _assert_rows_match(rows["torch"], rows["jax"], RIP_DISTANCE_ATOL,
                       keys=("steps", "collisions", "success", "distance"))


def test_sweep_skips_cached_variants(sweeps, capsys):  # pylint: disable=redefined-outer-name
  roots, got, _ = sweeps
  again = rip_sweep.run(out=roots["torch"], variants=VARIANTS, num_models=K,
                        horizon=HORIZON, device="cpu",
                        tasks=_tasks(pipeline.suites()["carnovel"], TASKS))
  assert again == got
  logged = capsys.readouterr().out
  assert logged.count("SKIP") == 2 and "evaluating" not in logged
  with pytest.raises(ValueError, match="RUN_NUM_MODELS"):
    rip_sweep.run(out=roots["torch"], num_models=4, device="cpu")


def test_knobs_read_when_run(monkeypatch):
  monkeypatch.setenv("RUN_VARIANTS", json.dumps([["rip_ma", 3]]))
  monkeypatch.setenv("RUN_NUM_MODELS", "3")
  k = rip_sweep.knobs(horizon=7)
  assert k["variants"] == [["rip_ma", 3]] and k["num_models"] == 3
  assert k["horizon"] == 7
  monkeypatch.delenv("RUN_VARIANTS")
  assert rip_sweep.knobs()["variants"] == rip_sweep.VARIANTS
