"""RIP-WCM against DIM on CARNOVEL at 20 episodes a task (seed 11), to
pool with the pipeline's 10-episode table run (seed 7) for a
CI-separated comparison.  Port of the JAX package's
``scripts/headtohead_r5.py``.

    python -m oatomobile_torch.experiments.headtohead [--cpu]

Reads the pipeline's checkpoints and knobs (``RUN_OUT`` defaults to the
round-5 run's directory) and writes ``RUN_OUT/carnovel20_<policy>/``; a
policy whose summary exists is skipped.
"""

import json
import os
from typing import Mapping, Optional

from oatomobile_torch.experiments import pipeline, round5

EPISODES, SEED = 20, 11


def run(*, out: Optional[str] = None, horizon: int = pipeline.HORIZON,
        tasks: Optional[Mapping] = None, device="cuda") -> None:
  from oatomobile_torch.benchmarks.batched_eval import evaluate_batched  # pylint: disable=import-outside-toplevel

  out = os.environ.get("RUN_OUT", round5.DEFAULTS["RUN_OUT"]) \
      if out is None else out
  tasks = pipeline.suites()["carnovel"] if tasks is None else tasks
  factories = pipeline.policies(out=out, device=device)
  for name in ("rip_wcm", "dim"):
    log_dir = os.path.join(out, "carnovel20_{}".format(name))
    if os.path.exists(os.path.join(log_dir, "summary.json")):
      continue
    evaluate_batched(tasks, policy_fn=factories[name](), log_dir=log_dir,
                     horizon=horizon, num_episodes=EPISODES, seed=SEED,
                     device=device)
    with open(os.path.join(log_dir, "summary.json")) as fp:
      s = json.load(fp)["summary"]
    print(name, s["success_rate"], s["success_ci95"], flush=True)
  print("HEADTOHEAD DONE")


def main(argv=None) -> None:
  run(device=pipeline.parse_device(__doc__.splitlines()[0], argv))


if __name__ == "__main__":
  main()
