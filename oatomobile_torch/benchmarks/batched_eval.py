"""Batched benchmark evaluation: every task is one scene of a batched
rollout.  Port of the JAX package's ``benchmarks/batched_eval.py``.

The reference evaluates benchmark tasks one env and one episode at a
time.  Here tasks are grouped by town, each group becomes one scene batch
(origin/destination from the task configs), and one closed-loop rollout
produces every episode's metrics at once: CARNOVEL's 27 tasks are two
batches (Town03, Town04).  Where the JAX package jits the rollout's
``lax.scan``, the metric step runs on static buffers and, on a card, is
captured into a CUDA graph and replayed once a step; the metrics reach
the host once per town group.
"""

import json
import os
import re
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch

from oatomobile_torch import device as device_lib
from oatomobile_torch import graphs
from oatomobile_torch.maps import load_town
from oatomobile_torch.sim import (autopilot_policy, init_scene_batch,
                                  make_params, world_step)
from oatomobile_torch.sim.types import clone_state, copy_state_
from oatomobile_torch.sim.util import constant, norm

HORIZON = 1500  # the reference's CARNOVEL horizon
ROUTE_CAPACITY = 2048


METRIC_DTYPES = {"steps": torch.int32, "collisions": torch.int32,
                 "lane_invasions": torch.int32, "distance": torch.float32,
                 "returns": torch.float32, "success": torch.bool,
                 "active": torch.bool}


def _metrics_step(params, states, m, policy, proximity):
  """One step of the episode-metric rollout: (metrics, states) after it,
  as new tensors."""
  active = m["active"]
  frozen_action = constant((0.0, 0.0, 1.0), states.hero_xy.device)
  actions, states = policy(params, states)
  actions = torch.where(active[:, None], actions, frozen_action)
  new_states = world_step(params, states, actions)
  collided = (new_states.collision > 0.0) & active
  arrived = (norm(new_states.hero_xy - new_states.destination_xy) <
             proximity) & active
  m = {
      "steps": m["steps"] + active.to(torch.int32),
      "collisions": m["collisions"] + collided.to(torch.int32),
      "lane_invasions": m["lane_invasions"] +
                        torch.where(active, new_states.lane_invasion, 0),
      "distance": m["distance"] + torch.where(
          active, norm(new_states.hero_xy - states.hero_xy), 0.0),
      "returns": m["returns"] + torch.where(arrived, 1.0, 0.0) +
                 torch.where(collided, -1.0, 0.0),
      "success": m["success"] | arrived,
      "active": active & ~collided & ~arrived,
  }
  return m, new_states


def _initial_metrics(batch_size: int, device) -> Dict[str, torch.Tensor]:
  m = {k: torch.zeros(batch_size, dtype=dtype, device=device)
       for k, dtype in METRIC_DTYPES.items()}
  m["active"].fill_(True)
  return m


class _MetricsRollout:
  """The episode-metric step on static copies of ``states`` and the
  metrics (``states`` and ``metrics``), captured into a CUDA graph on a
  card (``graphs.CapturedStep``, the counterpart of the JAX package's
  jitted scan); ``run(n)`` takes ``n`` steps."""

  def __init__(self, params, states, policy, proximity: float = 7.5):
    device = states.hero_xy.device
    self.states = clone_state(states)
    self.metrics = _initial_metrics(states.batch_size, device)

    def step():
      m, new_states = _metrics_step(params, self.states, self.metrics,
                                    policy, proximity)
      for k, v in m.items():
        self.metrics[k].copy_(v)
      copy_state_(self.states, new_states)

    self._step = graphs.CapturedStep(step, device,
                                     pool=graphs.new_pool(device))

  def run(self, num_steps: int) -> None:
    for _ in range(num_steps):
      self._step()


def _episode_metrics_rollout(params, states, policy, num_steps: int,
                             proximity: float = 7.5):
  """Rollout WITHOUT auto-reset, accumulating per-scene episode metrics
  with CARNOVEL semantics: an episode ends on a collision or on arrival
  within ``proximity`` m of the destination, and its scene is frozen
  after (the policy still runs on every scene, then frozen scenes get a
  full brake, [0, 0, 1]).  Runs ``_MetricsRollout``.  Returns (final
  states, metrics of [B] tensors on the states' device), the caller's own
  copies."""
  rollout = _MetricsRollout(params, states, policy, proximity)
  rollout.run(num_steps)
  return (clone_state(rollout.states),
          {k: v.clone() for k, v in rollout.metrics.items()})


def _episode_metrics_rollout_eager(params, states, policy, num_steps: int,
                                   proximity: float = 7.5):
  """``_episode_metrics_rollout`` as a plain loop that launches every op
  from the host: the yardstick that tests and ``chip_smoke.py`` hold the
  captured step against."""
  m = _initial_metrics(states.batch_size, states.hero_xy.device)
  for _ in range(num_steps):
    m, states = _metrics_step(params, states, m, policy, proximity)
  return states, m


def town_group_scenes(town_name: str, configs, num_episodes: int = 1,
                      seed: int = 0, device="cuda"):
  """(params, states) of one town's tasks: scene ``e * T + i`` is episode
  ``e`` of task ``configs[i]`` (T tasks), at the task's origin and
  destination with its configured traffic."""
  town = load_town(town_name)
  params = make_params(town, device=device)
  E = int(num_episodes)
  # Actor arrays pad to the group max but alive-mask down per task: each
  # task keeps its own configured traffic density.
  states = init_scene_batch(
      town,
      len(configs) * E,
      num_vehicles=np.tile(np.asarray(
          [int(c.get("num_vehicles", 0)) for c in configs]), E),
      num_pedestrians=np.tile(np.asarray(
          [int(c.get("num_pedestrians", 0)) for c in configs]), E),
      route_capacity=ROUTE_CAPACITY,
      seed=seed,
      spawn_points=np.tile(np.asarray([c["origin"] for c in configs]), E),
      destinations=np.tile(np.asarray([c["destination"] for c in configs]),
                           E),
      device=device,
  )
  return params, states


def task_family(task_id: str) -> str:
  """'AbnormalTurns5-v0' -> 'AbnormalTurns'; 'Town01_Turn22-v0' ->
  'Town01_Turn' (the paper's per-family reporting unit,
  arXiv:2006.14911 Table 1)."""
  return re.sub(r"\d+-v\d+$", "", task_id)


def _binomial_ci95(p: float, n: int) -> float:
  """Normal-approximation 95% half-width for a rate over n episodes."""
  if n <= 0:
    return 0.0
  return float(1.96 * np.sqrt(max(p * (1.0 - p), 0.0) / n))


def summarize(results: Dict[str, Dict[str, float]]) -> Dict:
  """Aggregates per-episode results: overall rates with 95% CIs and a
  per-family table decomposing failures into collision vs timeout."""
  def rows(items):
    succ = [bool(r["success"]) for r in items]
    coll = [r["collisions"] > 0 for r in items]
    tout = [not s and not c for s, c in zip(succ, coll)]
    n = len(items)
    p = float(np.mean(succ)) if n else 0.0
    return {
        "episodes": n,
        "success_rate": p,
        "success_ci95": _binomial_ci95(p, n),
        "collision_rate": float(np.mean(coll)) if n else 0.0,
        "timeout_rate": float(np.mean(tout)) if n else 0.0,
        "mean_distance": float(np.mean([r["distance"] for r in items]))
                         if n else 0.0,
    }

  episodes = []
  families: Dict[str, list] = {}
  for task_id, row in results.items():
    eps = row.get("episodes", [row])
    episodes.extend(eps)
    families.setdefault(task_family(task_id), []).extend(eps)
  summary = rows(episodes)
  summary["num_tasks"] = len(results)
  summary["per_family"] = {f: rows(items)
                           for f, items in sorted(families.items())}
  return summary


def evaluate_batched(
    tasks: Mapping[str, Mapping],
    policy_fn: Optional[Callable] = None,
    log_dir: Optional[str] = None,
    horizon: int = HORIZON,
    noise: float = 0.0,
    seed: int = 0,
    num_episodes: int = 1,
    device="cuda",
) -> Dict[str, Dict[str, float]]:
  """Evaluates every task of a benchmark in town-grouped batches.

  Args:
    tasks: task_id -> config dict (town/origin/destination/num_vehicles...)
      — e.g. the tasks of ``carnovel``/``corl2017``.
    policy_fn: optional ``(params, states) -> (actions, states)`` batched
      policy (e.g. ``make_rip_policy``) on ``device``; defaults to the
      autopilot expert.
    log_dir: when given, writes per-task metrics.csv like
      ``Benchmark.evaluate`` plus a summary.json.
    noise: the autopilot's epsilon-noise (ignored with ``policy_fn``).
    seed: base seed for scene initialisation (NPC placement/speeds,
      light phases, expert noise).
    num_episodes: episodes per task, evaluated as extra replicas inside
      the same batched rollout; each replica draws independent traffic,
      and the summary carries 95% CIs.
    device: where the scenes live; ``"cuda"`` unless the caller asks for
      ``"cpu"``.  Raises when it names CUDA and no card is present.

  Returns:
    task_id -> metric dict; with num_episodes > 1 each row additionally
    carries an ``episodes`` list and the scalar fields are per-task
    means (success = mean success rate).
  """
  device = device_lib.resolve(device)
  by_town: Dict[str, list] = {}
  for task_id, config in tasks.items():
    by_town.setdefault(config["town"], []).append((task_id, config))

  if policy_fn is None:
    def policy_fn(params, state_batch):
      return autopilot_policy(params, state_batch, noise=noise)

  E = int(num_episodes)
  results: Dict[str, Dict[str, float]] = {}
  for town_name, group in sorted(by_town.items()):
    ids = [t for t, _ in group]
    T = len(group)
    params, states = town_group_scenes(town_name, [c for _, c in group], E,
                                       seed, device)
    with torch.no_grad():
      _, metrics = _episode_metrics_rollout(params, states, policy_fn,
                                            horizon)
    metrics = {k: v.cpu().numpy() for k, v in metrics.items()}
    for i, task_id in enumerate(ids):
      eps = []
      for e in range(E):
        j = e * T + i
        eps.append({
            "steps": int(metrics["steps"][j]),
            "collisions": int(metrics["collisions"][j]),
            "lane_invasions": int(metrics["lane_invasions"][j]),
            "distance": float(metrics["distance"][j]),
            "returns": float(metrics["returns"][j]),
            "success": bool(metrics["success"][j]),
        })
      if E == 1:
        row = dict(eps[0])
      else:
        row = {
            "steps": float(np.mean([x["steps"] for x in eps])),
            "collisions": float(np.mean([x["collisions"] for x in eps])),
            "lane_invasions": float(np.mean([x["lane_invasions"]
                                             for x in eps])),
            "distance": float(np.mean([x["distance"] for x in eps])),
            "returns": float(np.mean([x["returns"] for x in eps])),
            "success": float(np.mean([x["success"] for x in eps])),
            "episodes": eps,
        }
      results[task_id] = row

  if log_dir is not None:
    os.makedirs(log_dir, exist_ok=True)
    for task_id, row in results.items():
      task_dir = os.path.join(log_dir, task_id)
      os.makedirs(task_dir, exist_ok=True)
      keys = [k for k in row if k != "episodes"]
      with open(os.path.join(task_dir, "metrics.csv"), "w") as fp:
        fp.write(",".join(keys) + "\n")
        fp.write(",".join(str(row[k]) for k in keys) + "\n")
    summary = summarize(results)
    with open(os.path.join(log_dir, "summary.json"), "w") as fp:
      json.dump({"summary": summary, "tasks": results}, fp, indent=2)
  return results
