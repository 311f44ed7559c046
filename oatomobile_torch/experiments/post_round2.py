"""After a round-2 run: RIP-BCM on CARNOVEL, the CoRL2017 autopilot row,
the flow profile and the bench.  Port of the JAX package's
``scripts/post_experiment.py``.

    python -m oatomobile_torch.experiments.post_round2 [--cpu]

Run after ``round2`` with the same RUN_OUT.  Four steps, in the JAX
script's order, each of them failing the run when it fails:

  1. ``python -m oatomobile_torch.experiments.round2`` with
     ``RUN_POLICIES=rip_bcm`` (round 2's phases resume: only the BCM row
     is evaluated);
  2. the autopilot over CoRL2017's tasks through ``evaluate_batched``
     (seed 0, one episode a task, horizon RUN_HORIZON, 1500 by default),
     in this process, into ``RUN_OUT/corl2017_autopilot/``;
  3. ``python -m oatomobile_torch.experiments.profile_flow`` (the DIM
     plan's split at 1024 scenes);
  4. ``python -m oatomobile_torch.bench`` (its ``BENCH_*`` knobs from the
     environment).

``--cpu`` is passed on to every step.
"""

import os
import subprocess
import sys
from typing import Mapping, Optional

from oatomobile_torch import device as device_lib
from oatomobile_torch.experiments import pipeline, round2

TAG = "post"
# The directory that holds the package, put on the steps' module path.
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def log(msg: str) -> None:
  pipeline.log(msg, tag=TAG)


def _module(name: str, env: Mapping[str, str], device: str) -> None:
  """``python -m name`` (``--cpu`` with the CPU) in ``env``; raises when
  it fails."""
  command = [sys.executable, "-m", name] + (["--cpu"] if device == "cpu"
                                            else [])
  subprocess.run(command, env=dict(env), check=True)


def run(*, out: Optional[str] = None, horizon: Optional[int] = None,
        corl_tasks: Optional[Mapping] = None, device="cuda") -> None:
  """The four steps (module docstring) on round 2's ``out``."""
  from oatomobile_torch.benchmarks.batched_eval import evaluate_batched  # pylint: disable=import-outside-toplevel

  device = device_lib.resolve(device).type
  k = round2.knobs(out=out, horizon=horizon)
  path = os.environ.get("PYTHONPATH")
  env = dict(os.environ, RUN_OUT=k.out, PYTHONPATH=ROOT if not path else
             os.pathsep.join([ROOT, path]))

  log("rip_bcm CARNOVEL eval")
  _module("oatomobile_torch.experiments.round2",
          dict(env, RUN_POLICIES="rip_bcm"), device)

  log("CoRL2017 autopilot eval")
  if corl_tasks is None:
    corl_tasks = pipeline.suites()["corl2017"]
  log_dir = os.path.join(k.out, "corl2017_autopilot")
  evaluate_batched(corl_tasks, policy_fn=None, log_dir=log_dir,
                   horizon=k.horizon, device=device)
  log("corl2017 autopilot: {}".format(
      pipeline.read_summary(os.path.join(log_dir, "summary.json"))))

  log("flow profile")
  _module("oatomobile_torch.experiments.profile_flow", env, device)

  log("bench")
  _module("oatomobile_torch.bench", env, device)
  log("done")


def main(argv=None) -> None:
  run(device=pipeline.parse_device(__doc__.splitlines()[0], argv))


if __name__ == "__main__":
  main()
