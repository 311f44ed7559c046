"""The scaled DIM run: a large collected dataset, packed, DIM trained on
it, then CARNOVEL with the learned policy.  Port of the JAX package's
``scripts/train_dim_full.py``.

    python -m oatomobile_torch.experiments.train_dim_full [--cpu]

Collects Town01 in chunks of 24 episodes (8 vehicles, the autopilot's
noise, seed ``100 + episodes done``) into ``RUN_OUT/raw``, processes and
packs it (skipped when ``RUN_OUT/packed`` exists), trains DIM in
``RUN_OUT/dim`` resumed from its last train state (``resume=True``:
a finished run trains nothing again), evaluates CARNOVEL into
``RUN_OUT/carnovel_dim`` and writes ``RUN_OUT/summary.json``.  Knobs
(environment, read when ``run`` runs; ``run`` also takes them as
keywords): RUN_OUT, RUN_EPISODES (96), RUN_EP_STEPS (400), RUN_NOISE
(0.1), RUN_EPOCHS (40), RUN_BATCH (256), and the port's RUN_HORIZON
(1500, the suite's) for short runs.
"""

import json
import os
from typing import Mapping, Optional

from oatomobile_torch.experiments import pipeline

CHUNK = 24  # episodes a collection chunk, to bound device and host memory


def log(msg: str) -> None:
  pipeline.log(msg, tag="run")


def knobs(**overrides) -> dict:
  env = os.environ.get
  k = dict(out=env("RUN_OUT", pipeline.default_out("run")),
           episodes=int(env("RUN_EPISODES", 96)),
           ep_steps=int(env("RUN_EP_STEPS", 400)),
           noise=float(env("RUN_NOISE", 0.1)),
           epochs=int(env("RUN_EPOCHS", 40)),
           batch=int(env("RUN_BATCH", 256)),
           horizon=int(env("RUN_HORIZON", pipeline.HORIZON)))
  k.update({name: v for name, v in overrides.items() if v is not None})
  return k


def run(*, out: Optional[str] = None, episodes: Optional[int] = None,
        ep_steps: Optional[int] = None, noise: Optional[float] = None,
        epochs: Optional[int] = None, batch: Optional[int] = None,
        horizon: Optional[int] = None, tasks: Optional[Mapping] = None,
        device="cuda") -> dict:
  """The run (module docstring); returns the summary it wrote.  The
  trainer draws plans every 10 epochs (matplotlib)."""
  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.baselines.learned.dim.policy import make_dim_policy
  from oatomobile_torch.baselines.learned.dim.train import MODALITIES, train
  from oatomobile_torch.benchmarks.batched_eval import evaluate_batched
  from oatomobile_torch.datasets.carla import CARLADataset

  k = knobs(out=out, episodes=episodes, ep_steps=ep_steps, noise=noise,
            epochs=epochs, batch=batch, horizon=horizon)
  out = k["out"]
  os.makedirs(out, exist_ok=True)
  raw = os.path.join(out, "raw")
  processed = os.path.join(out, "processed")
  packed = os.path.join(out, "packed")
  summary = {}

  if not CARLADataset.is_packed(packed):
    done = 0
    while done < k["episodes"]:
      n = min(CHUNK, k["episodes"] - done)
      log("collect chunk {} ({} eps x {} steps, noise={})".format(
          done // CHUNK, n, k["ep_steps"], k["noise"]))
      CARLADataset.collect_batched(
          town="Town01", output_dir=raw, num_episodes=n,
          num_steps=k["ep_steps"], num_vehicles=8, seed=100 + done,
          noise=k["noise"], device=device)
      done += n
    log("process")
    CARLADataset.process(raw, processed, num_frame_skips=5)
    log("pack")
    summary["num_samples"] = CARLADataset.pack(processed, packed, MODALITIES)
    log("dataset: {} samples".format(summary["num_samples"]))

  log("train {} epochs batch {}".format(k["epochs"], k["batch"]))
  state = train(packed, os.path.join(out, "dim"), batch_size=k["batch"],
                num_epochs=k["epochs"], use_mesh=False, plot_every=10,
                resume=True, device=device)
  records = pipeline.train_log(os.path.join(out, "dim"))
  summary["train_losses"] = [round(r["loss"], 2) for r in records]
  log("losses: {}".format(summary["train_losses"][-8:]))

  log("CARNOVEL eval with trained DIM")
  log_dir = os.path.join(out, "carnovel_dim")
  evaluate_batched(pipeline.suites()["carnovel"] if tasks is None else tasks,
                   policy_fn=make_dim_policy(state.model, num_plan_steps=20),
                   log_dir=log_dir, horizon=k["horizon"], device=device)
  summary["carnovel_dim"] = pipeline.read_summary(
      os.path.join(log_dir, "summary.json"))
  log("DIM CARNOVEL: {}".format(summary["carnovel_dim"]))
  with open(os.path.join(out, "summary.json"), "w") as fp:
    json.dump(summary, fp, indent=2)
  log("done")
  return summary


def main(argv=None) -> None:
  run(device=pipeline.parse_device(__doc__.splitlines()[0], argv))


if __name__ == "__main__":
  main()
