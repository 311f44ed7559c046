"""End-to-end demonstration: collect, process, train, then the trained
DIM against an untrained one in closed loop.  Port of the JAX package's
``scripts/demo_full_loop.py``.

    python -m oatomobile_torch.experiments.demo_full_loop [--cpu]

Collects Town01 with the autopilot (no traffic, seed 11) into
``DEMO_OUT/raw`` and processes it (skipped when ``DEMO_OUT/processed``
holds samples), trains DIM in ``DEMO_OUT/dim``, then drives a Town01
``BatchedEnv`` (seed 77) with the trained and with untrained weights
(seeded 0) and writes ``DEMO_OUT/summary.json``: the sample count, the
last epochs' losses, each policy's mean distance, collided scenes and
completed episodes.  Knobs (environment, read when ``run`` runs; ``run``
also takes them as keywords): DEMO_OUT, DEMO_EPISODES (24), DEMO_EP_STEPS
(300), DEMO_EPOCHS (12), DEMO_BATCH (128), DEMO_EVAL_SCENES (256),
DEMO_EVAL_STEPS (300).
"""

import json
import os
from typing import Optional

from oatomobile_torch.experiments import pipeline


def log(msg: str) -> None:
  pipeline.log(msg, tag="demo")


def knobs(**overrides) -> dict:
  env = os.environ.get
  k = dict(out=env("DEMO_OUT", pipeline.default_out("demo")),
           episodes=int(env("DEMO_EPISODES", 24)),
           ep_steps=int(env("DEMO_EP_STEPS", 300)),
           epochs=int(env("DEMO_EPOCHS", 12)),
           batch=int(env("DEMO_BATCH", 128)),
           eval_scenes=int(env("DEMO_EVAL_SCENES", 256)),
           eval_steps=int(env("DEMO_EVAL_STEPS", 300)))
  k.update({name: v for name, v in overrides.items() if v is not None})
  return k


def closed_loop(model, scenes: int, steps: int, device) -> dict:
  """A Town01 rollout (no traffic, seed 77) driven by ``model``'s DIM
  policy (20 plan steps)."""
  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.baselines.learned.dim.policy import make_dim_policy
  from oatomobile_torch.envs.batched import BatchedEnv
  env = BatchedEnv("Town01", batch_size=scenes, num_vehicles=0, seed=77,
                   device=device)
  _, _, stats = env.rollout(steps, policy=make_dim_policy(
      model, num_plan_steps=20))
  stats = {k: v.cpu().numpy() for k, v in stats.items()}
  return {"mean_distance_m": float(stats["distance"].mean()),
          "collision_scenes": int((stats["collisions"] > 0).sum()),
          "episodes_completed": int(stats["episodes"].sum())}


def run(*, out: Optional[str] = None, episodes: Optional[int] = None,
        ep_steps: Optional[int] = None, epochs: Optional[int] = None,
        batch: Optional[int] = None, eval_scenes: Optional[int] = None,
        eval_steps: Optional[int] = None, device="cuda") -> dict:
  """The demonstration (module docstring); returns the summary it
  wrote.  The trainer draws plans as its default says (matplotlib)."""
  # pylint: disable=import-outside-toplevel
  import torch
  from oatomobile_torch.baselines.learned.dim.train import train
  from oatomobile_torch.datasets.carla import CARLADataset
  from oatomobile_torch.models.dim import ImitativeModel

  k = knobs(out=out, episodes=episodes, ep_steps=ep_steps, epochs=epochs,
            batch=batch, eval_scenes=eval_scenes, eval_steps=eval_steps)
  out = k["out"]
  os.makedirs(out, exist_ok=True)
  raw = os.path.join(out, "raw")
  processed = os.path.join(out, "processed")
  summary = {}
  if not os.path.isdir(processed) or not os.listdir(processed):
    log("collecting {} episodes x {} steps".format(k["episodes"],
                                                  k["ep_steps"]))
    CARLADataset.collect_batched(
        town="Town01", output_dir=raw, num_episodes=k["episodes"],
        num_steps=k["ep_steps"], num_vehicles=0, seed=11, device=device)
    log("processing")
    CARLADataset.process(raw, processed, num_frame_skips=5)
  summary["num_samples"] = len(os.listdir(processed))
  log("dataset: {} samples".format(summary["num_samples"]))

  log("training DIM: {} epochs batch {}".format(k["epochs"], k["batch"]))
  state = train(processed, os.path.join(out, "dim"), batch_size=k["batch"],
                num_epochs=k["epochs"], use_mesh=False, device=device)
  losses = [r["loss"] for r in pipeline.train_log(
      os.path.join(out, "dim"))][-k["epochs"]:]
  summary["train_losses"] = losses
  log("losses: {}".format([round(x, 1) for x in losses]))

  untrained = ImitativeModel((4, 2),
                             generator=torch.Generator().manual_seed(0),
                             device=device)
  results = {}
  for name, model in (("trained", state.model), ("untrained", untrained)):
    log("closed-loop eval: {}".format(name))
    results[name] = closed_loop(model, k["eval_scenes"], k["eval_steps"],
                                device)
    log("{}: {}".format(name, results[name]))
  summary["closed_loop"] = results
  with open(os.path.join(out, "summary.json"), "w") as fp:
    json.dump(summary, fp, indent=2)
  log("done -> {}/summary.json".format(out))
  return summary


def main(argv=None) -> None:
  run(device=pipeline.parse_device(__doc__.splitlines()[0], argv))


if __name__ == "__main__":
  main()
