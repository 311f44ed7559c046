"""The CARNOVEL agent comparison: the autopilot, DIM and RIP (WCM, MA) on
the distribution-shift suite, from the newest epoch of a trained
ensemble.  Port of the JAX package's ``scripts/eval_carnovel_agents.py``.

    python -m oatomobile_torch.experiments.eval_carnovel_agents [--cpu]

Reads ``RUN_OUT/rip/ckpts/ensemble-<epoch>`` (the port's ``.pt`` or the
JAX package's ``.flax``; K from the file) and writes
``RUN_OUT/carnovel_<policy>/`` and ``RUN_OUT/agents_summary.json``.
"""

import json
import os
from typing import Mapping, Optional

from oatomobile_torch.experiments import pipeline


def log(msg: str) -> None:
  pipeline.log(msg, tag="eval")


def run(out: str, *, horizon: int = pipeline.HORIZON,
        tasks: Optional[Mapping] = None, device="cuda") -> dict:
  """Evaluates the four agents and writes ``agents_summary.json``;
  returns the summaries by agent."""
  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.baselines.learned.dim.policy import make_dim_policy
  from oatomobile_torch.baselines.learned.rip.policy import make_rip_policy
  from oatomobile_torch.benchmarks.batched_eval import evaluate_batched

  ckpt_dir = os.path.join(out, "rip", "ckpts")
  epoch = pipeline.latest_epoch(ckpt_dir, "ensemble")
  models = pipeline.read_ensemble(ckpt_dir, epoch, device=device)
  log("loaded ensemble epoch {}".format(epoch))
  tasks = pipeline.suites()["carnovel"] if tasks is None else tasks

  policies = {
      "autopilot": None,
      "dim": make_dim_policy(models[0], num_plan_steps=20),
      "rip_wcm": make_rip_policy(models, algorithm="WCM"),
      "rip_ma": make_rip_policy(models, algorithm="MA"),
  }
  table = {}
  for name, policy in policies.items():
    log("evaluating {}".format(name))
    log_dir = os.path.join(out, "carnovel_" + name)
    evaluate_batched(tasks, policy_fn=policy, log_dir=log_dir,
                     horizon=horizon, device=device)
    table[name] = pipeline.read_summary(os.path.join(log_dir,
                                                     "summary.json"))
    log("{}: {}".format(name, table[name]))
  with open(os.path.join(out, "agents_summary.json"), "w") as fp:
    json.dump(table, fp, indent=2)
  log("done")
  return table


def main(argv=None) -> None:
  device = pipeline.parse_device(__doc__.splitlines()[0], argv)
  run(os.environ.get("RUN_OUT", pipeline.default_out("run")), device=device)


if __name__ == "__main__":
  main()
