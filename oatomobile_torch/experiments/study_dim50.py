"""Input-resolution study: DIM at 50x50 against the reference's 100x100.
Port of the JAX package's ``scripts/study_dim50.py``.

    python -m oatomobile_torch.experiments.study_dim50 [--cpu]

Trains an otherwise identical DIM at ``input_size=(50, 50)`` (a quarter
of the encoder's pixels) on the round-3 pack ``RUN_OUT/packed`` into
``RUN_OUT/dim50`` (skipped when its best checkpoint exists, the port's
``.pt`` or the JAX package's ``.flax``), evaluates it on CARNOVEL (seed
7) into ``RUN_OUT/carnovel_dim50`` and writes ``RUN_OUT/dim50_study.json``:
the CARNOVEL summary's rates and the best val NLL, so that the encoder's
saving carries its quality cost.  Knobs (environment, read when ``run``
runs; ``run`` also takes them as keywords): RUN_OUT, STUDY_EPOCHS (40),
STUDY_EPISODES (10 a task), RUN_BRIDGE, and the port's RUN_HORIZON (1500,
the suite's) for short runs.
"""

import json
import os
from typing import Mapping, Optional

from oatomobile_torch.experiments import pipeline

INPUT_SIZE = (50, 50)
BATCH = 512
SUMMARY_KEYS = ("success_rate", "success_ci95", "collision_rate",
                "timeout_rate", "episodes")


def log(msg: str) -> None:
  pipeline.log(msg, tag="dim50")


def knobs(**overrides) -> dict:
  env = os.environ.get
  k = dict(out=env("RUN_OUT", pipeline.default_out("r3")),
           epochs=int(env("STUDY_EPOCHS", 40)),
           episodes=int(env("STUDY_EPISODES", 10)),
           bridge=json.loads(env("RUN_BRIDGE", pipeline.BRIDGE)),
           horizon=int(env("RUN_HORIZON", pipeline.HORIZON)))
  k.update({name: v for name, v in overrides.items() if v is not None})
  return k


def run(*, out: Optional[str] = None, epochs: Optional[int] = None,
        episodes: Optional[int] = None, bridge: Optional[Mapping] = None,
        horizon: Optional[int] = None, tasks: Optional[Mapping] = None,
        batch: int = BATCH, device="cuda") -> dict:
  """The study (module docstring); returns what it wrote."""
  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.baselines.learned.dim.policy import make_dim_policy
  from oatomobile_torch.baselines.learned.dim.train import train
  from oatomobile_torch.benchmarks.batched_eval import (evaluate_batched,
                                                        summarize)
  from oatomobile_torch.models.dim import ImitativeModel
  from oatomobile_torch.utils.checkpoint import read_params

  k = knobs(out=out, epochs=epochs, episodes=episodes, bridge=bridge,
            horizon=horizon)
  out_dir = os.path.join(k["out"], "dim50")
  ckpt_dir = os.path.join(out_dir, "ckpts")
  if not pipeline.has_best(ckpt_dir, "model"):
    log("train DIM @50x50, {} epochs".format(k["epochs"]))
    train(os.path.join(k["out"], "packed"), out_dir, batch_size=batch,
          num_epochs=k["epochs"], input_size=INPUT_SIZE, plot_every=0,
          device=device)
  model = read_params(pipeline.checkpoint_path(ckpt_dir, "model", "best"),
                      ImitativeModel((4, 2), INPUT_SIZE, device=device))
  policy = make_dim_policy(model, num_plan_steps=20, **k["bridge"])

  log("evaluating CARNOVEL ({} episodes/task)".format(k["episodes"]))
  results = evaluate_batched(
      pipeline.suites()["carnovel"] if tasks is None else tasks,
      policy_fn=policy, num_episodes=k["episodes"], seed=7,
      log_dir=os.path.join(k["out"], "carnovel_dim50"), horizon=k["horizon"],
      device=device)
  summary = summarize(results)
  best_val = min(r.get("val_loss", float("inf"))
                 for r in pipeline.train_log(out_dir))
  result = {"carnovel": {key: summary[key] for key in SUMMARY_KEYS},
            "best_val_nll": best_val}
  with open(os.path.join(k["out"], "dim50_study.json"), "w") as fp:
    json.dump(result, fp, indent=2)
  log("done: {}".format(result))
  return result


def main(argv=None) -> None:
  run(device=pipeline.parse_device(__doc__.splitlines()[0], argv))


if __name__ == "__main__":
  main()
