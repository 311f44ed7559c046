"""CARNOVEL sweep over RIP's aggregations and planning-step budgets on
one trained ensemble.  Port of the JAX package's
``scripts/eval_rip_sweep.py``.

    python -m oatomobile_torch.experiments.rip_sweep [--cpu]

Holds the bridge fixed and varies (algorithm, num_plan_steps) on the
ensemble ``RUN_OUT/rip/ckpts/ensemble-best`` (the port's ``.pt`` or the
JAX package's ``.flax``), BCM included; ``dim`` is member 0 alone.
Writes ``RUN_OUT/carnovel_<variant>_<steps>steps/`` and
``RUN_OUT/rip_sweep.json`` ({variant key: summary}); a variant already in
``rip_sweep.json`` is skipped (a changed RUN_BRIDGE does not invalidate
it: rerun with a fresh RUN_OUT).  Knobs (environment, read when ``run``
runs; ``run`` also takes them as keywords):

  RUN_OUT         output directory (default: under the system's
                  temporary directory)
  RUN_BRIDGE      JSON keyword arguments of the plan -> control bridge
  RUN_VARIANTS    JSON [[name, num_plan_steps], ...], name ``dim`` or
                  ``rip_<wcm|bcm|ma>`` (dim 10, rip_wcm/bcm/ma 20)
  RUN_NUM_MODELS  the ensemble's size K (4)
  RUN_HORIZON     the evaluation's horizon (1500, the suite's; the port's
                  knob, for short runs)
"""

import json
import os
from typing import Mapping, Optional

from oatomobile_torch.experiments import pipeline

VARIANTS = [["dim", 10], ["rip_wcm", 20], ["rip_bcm", 20], ["rip_ma", 20]]


def log(msg: str) -> None:
  pipeline.log(msg, tag="sweep")


def knobs(**overrides) -> dict:
  """The knobs from the environment now, with the given non-None
  ``overrides`` in their place."""
  env = os.environ.get
  k = dict(out=env("RUN_OUT", pipeline.default_out("r2")),
           bridge=json.loads(env("RUN_BRIDGE", pipeline.BRIDGE)),
           variants=json.loads(env("RUN_VARIANTS", json.dumps(VARIANTS))),
           num_models=int(env("RUN_NUM_MODELS", 4)),
           horizon=int(env("RUN_HORIZON", pipeline.HORIZON)))
  k.update({name: v for name, v in overrides.items() if v is not None})
  return k


def run(*, out: Optional[str] = None, variants=None,
        num_models: Optional[int] = None, bridge: Optional[Mapping] = None,
        horizon: Optional[int] = None, tasks: Optional[Mapping] = None,
        device="cuda") -> dict:
  """Evaluates each variant on CARNOVEL (``tasks``: the suite's 27 by
  default; one episode a task, seed 0) and returns the table it wrote."""
  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.baselines.learned.dim.policy import make_dim_policy
  from oatomobile_torch.baselines.learned.rip.policy import make_rip_policy
  from oatomobile_torch.benchmarks.batched_eval import evaluate_batched

  k = knobs(out=out, variants=variants, num_models=num_models,
            bridge=bridge, horizon=horizon)
  models = pipeline.read_ensemble(os.path.join(k["out"], "rip", "ckpts"),
                                  device=device)
  if len(models) != k["num_models"]:
    raise ValueError("the ensemble holds {} members, RUN_NUM_MODELS is {}"
                     .format(len(models), k["num_models"]))
  log("loaded ensemble-best (K={})".format(len(models)))
  tasks = pipeline.suites()["carnovel"] if tasks is None else tasks

  path = os.path.join(k["out"], "rip_sweep.json")
  table = {}
  if os.path.exists(path):
    with open(path) as fp:
      table = json.load(fp)
  for name, steps in k["variants"]:
    key = "{}_{}steps".format(name, steps)
    if key in table:
      log("SKIP {} (cached result; rerun with a fresh RUN_OUT or delete "
          "rip_sweep.json if RUN_BRIDGE changed)".format(key))
      continue
    if name == "dim":
      policy = make_dim_policy(models[0], num_plan_steps=steps, **k["bridge"])
    else:
      policy = make_rip_policy(models, algorithm=name.split("_")[1].upper(),
                               num_plan_steps=steps, **k["bridge"])
    log("evaluating {}".format(key))
    log_dir = os.path.join(k["out"], "carnovel_" + key)
    evaluate_batched(tasks, policy_fn=policy, log_dir=log_dir,
                     horizon=k["horizon"], device=device)
    table[key] = pipeline.read_summary(os.path.join(log_dir, "summary.json"))
    log("{}: {}".format(key, table[key]))
    with open(path, "w") as fp:
      json.dump(table, fp, indent=2)
  log("done: {}".format(path))
  return table


def main(argv=None) -> None:
  run(device=pipeline.parse_device(__doc__.splitlines()[0], argv))


if __name__ == "__main__":
  main()
