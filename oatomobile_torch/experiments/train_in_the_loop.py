"""Train-in-the-loop imitation learning on one card: collect, train DIM,
evaluate, for several rounds.  Port of the JAX package's
``scripts/train_in_the_loop.py``.

    python -m oatomobile_torch.experiments.train_in_the_loop [--cpu]

Each round:

  1. COLLECT: batched autopilot rollouts packed on the device (fresh
     scenes and traffic each round, the density ramping to the
     benchmarks' 100 vehicles), merged with the earlier rounds' packs;
  2. TRAIN: DIM's NLL epochs on the whole pack, resumed from the last
     round's checkpoint (``resume=True``);
  3. EVALUATE: an in-distribution Town01 rollout driven by the learned
     policy, and the CARNOVEL distribution-shift suite.

Writes ``LOOP_OUT/history.json`` (and ``curve.png`` with matplotlib).
Knobs (environment, read when ``main`` runs): LOOP_ROUNDS (4),
LOOP_EPISODES (128), LOOP_EPOCHS (8), LOOP_CARNOVEL_EPISODES (3),
LOOP_OUT (a directory under the system's temporary directory).
"""

import json
import os
from typing import Mapping, Optional

import numpy as np

from oatomobile_torch.experiments import pipeline

# The round's Town01 rollout: scenes and steps.
ROLLOUT_SCENES, ROLLOUT_STEPS = 128, 300


def log(msg: str) -> None:
  pipeline.log(msg, tag="loop")


def knobs() -> dict:
  env = os.environ.get
  return dict(out=env("LOOP_OUT", pipeline.default_out("loop")),
              rounds=int(env("LOOP_ROUNDS", 4)),
              episodes=int(env("LOOP_EPISODES", 128)),
              epochs=int(env("LOOP_EPOCHS", 8)),
              carnovel_episodes=int(env("LOOP_CARNOVEL_EPISODES", 3)))


def evaluate(model, seed: int, *, carnovel_episodes: int,
             rollout_scenes: int = ROLLOUT_SCENES,
             rollout_steps: int = ROLLOUT_STEPS,
             carnovel_horizon: int = pipeline.HORIZON,
             carnovel_tasks: Optional[Mapping] = None,
             device="cuda") -> dict:
  """The in-distribution Town01 rollout and the CARNOVEL shift suite,
  driven by DIM (20 plan steps, epsilon 0.3, speed gain 1.2)."""
  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.baselines.learned.dim.policy import make_dim_policy
  from oatomobile_torch.benchmarks.batched_eval import (evaluate_batched,
                                                        summarize)
  from oatomobile_torch.envs.batched import BatchedEnv

  policy = make_dim_policy(model, num_plan_steps=20, epsilon=0.3,
                           speed_gain=1.2)
  env = BatchedEnv("Town01", batch_size=rollout_scenes, num_vehicles=0,
                   seed=seed, device=device)
  _, _, stats = env.rollout(rollout_steps, policy=policy)
  result = {
      "town01_mean_distance_m": float(stats["distance"].cpu().numpy().mean()),
      "town01_collision_free": float(
          (stats["collisions"].cpu().numpy() == 0).mean()),
  }
  tasks = (pipeline.suites()["carnovel"] if carnovel_tasks is None else
           carnovel_tasks)
  carnovel = summarize(evaluate_batched(
      tasks, policy_fn=policy, horizon=carnovel_horizon,
      num_episodes=carnovel_episodes, seed=seed, device=device))
  result["carnovel_success"] = carnovel["success_rate"]
  result["carnovel_success_ci95"] = carnovel["success_ci95"]
  result["carnovel_collision"] = carnovel["collision_rate"]
  return result


def run_round(round_i: int, *, out: Optional[str] = None,
              episodes: Optional[int] = None, epochs: Optional[int] = None,
              carnovel_episodes: Optional[int] = None,
              num_steps: int = 500, chunk_episodes: int = 64,
              batch_size: int = 256, rollout_scenes: int = ROLLOUT_SCENES,
              rollout_steps: int = ROLLOUT_STEPS,
              carnovel_horizon: int = pipeline.HORIZON,
              carnovel_tasks: Optional[Mapping] = None,
              device="cuda") -> dict:
  """Round ``round_i``: collects ``data_r<i>`` (``min(25 * i, 100)``
  vehicles, seed ``1000 * i + 7``; skipped when packed), merges rounds
  0..i into ``dataset_r<i>``, trains DIM in ``OUT/dim`` up to ``epochs *
  (i + 1)`` epochs (resumed), evaluates with seed ``31 + i`` and writes
  ``OUT/history.json`` (the earlier rounds' entries and this one).
  Keywords left None are read from the LOOP_* knobs; the sizes default to
  the JAX script's.  Returns the round's entry."""
  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.baselines.learned.dim.train import train
  from oatomobile_torch.datasets.carla import CARLADataset

  k = knobs()
  out = k["out"] if out is None else out
  episodes = k["episodes"] if episodes is None else episodes
  epochs = k["epochs"] if epochs is None else epochs
  carnovel_episodes = (k["carnovel_episodes"] if carnovel_episodes is None
                       else carnovel_episodes)
  os.makedirs(out, exist_ok=True)

  chunk_dir = os.path.join(out, "data_r{}".format(round_i))
  if not CARLADataset.is_packed(chunk_dir):
    log("round {}: collect {} episodes".format(round_i, episodes))
    CARLADataset.collect_packed(
        "Town01", chunk_dir, num_episodes=episodes, num_steps=num_steps,
        # The density ramps to the benchmarks' 100-vehicle traffic, so
        # later rounds add car-following and queueing coverage.
        num_vehicles=min(25 * round_i, 100), noise=0.2,
        chunk_episodes=chunk_episodes, image_size=(100, 100),
        seed=1000 * round_i + 7, device=device)
  chunks = [os.path.join(out, "data_r{}".format(i))
            for i in range(round_i + 1)]
  dataset_dir = os.path.join(out, "dataset_r{}".format(round_i))
  n = CARLADataset.merge_packed(chunks, dataset_dir)
  log("round {}: dataset {} samples".format(round_i, n))

  state = train(dataset_dir, os.path.join(out, "dim"), batch_size=batch_size,
                num_epochs=epochs * (round_i + 1), use_mesh=False,
                plot_every=0, resume=True, device=device)
  result = evaluate(state.model, seed=31 + round_i,
                    carnovel_episodes=carnovel_episodes,
                    rollout_scenes=rollout_scenes,
                    rollout_steps=rollout_steps,
                    carnovel_horizon=carnovel_horizon,
                    carnovel_tasks=carnovel_tasks, device=device)
  result["round"] = round_i
  result["samples"] = n
  log("round {}: eval {}".format(round_i, result))

  path = os.path.join(out, "history.json")
  history = []
  if os.path.exists(path):
    with open(path) as fp:
      history = [h for h in json.load(fp) if h["round"] < round_i]
  with open(path, "w") as fp:
    json.dump(history + [result], fp, indent=2)
  return result


def plot_curve(history, fname: str) -> None:
  """The rounds' CARNOVEL success (with its CI) and Town01 collision-free
  share (matplotlib, imported here)."""
  # pylint: disable=import-outside-toplevel
  import matplotlib
  matplotlib.use("Agg")
  import matplotlib.pyplot as plt

  rounds = [h["round"] for h in history]
  succ = np.array([h["carnovel_success"] for h in history])
  ci = np.array([h["carnovel_success_ci95"] for h in history])
  cf = [h["town01_collision_free"] for h in history]
  fig, ax = plt.subplots(figsize=(6, 4))
  ax.errorbar(rounds, succ, yerr=ci, marker="o",
              label="CARNOVEL success (shift)")
  ax.plot(rounds, cf, marker="s", label="Town01 collision-free (in-dist)")
  ax.set_xlabel("train-in-the-loop round")
  ax.set_ylabel("rate")
  ax.set_ylim(0, 1)
  ax.legend()
  ax.set_title("On-device collect->train->evaluate rounds (DIM)")
  fig.tight_layout()
  fig.savefig(fname, dpi=120)
  plt.close(fig)


def main(argv=None) -> None:
  device = pipeline.parse_device(__doc__.splitlines()[0], argv)
  k = knobs()
  history = [run_round(i, device=device) for i in range(k["rounds"])]
  plot_curve(history, os.path.join(k["out"], "curve.png"))
  log("done: {}/history.json, curve.png".format(k["out"]))


if __name__ == "__main__":
  main()
