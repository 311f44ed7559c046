"""Diagnose CoRL2017 Town02 timeouts: where do timed-out episodes spend
their steps, and how far along their route do they end?  Port of the JAX
package's ``scripts/diag_town02.py``.

    python -m oatomobile_torch.experiments.diag.town02 [--cpu]
        [--town Town02] [--episodes 3] [--horizon 1500] [--out FILE]

Runs every task of the town x E episodes with the autopilot and reports,
per outcome: the route-progress fraction, the fraction of steps spent
(near-)stopped, the distance left, and the NPCs' stalled fraction at the
end.  ``--out`` writes one row per episode (JSON, the JAX layout).
"""

import collections
import json

import numpy as np
import torch

from oatomobile_torch.experiments.diag import common

OUTCOMES = ("success", "collision", "timeout")


def initial(states) -> dict:
  B, device = states.batch_size, states.hero_xy.device
  return {"steps": torch.zeros(B, dtype=torch.int32, device=device),
          "stopped_steps": torch.zeros(B, dtype=torch.int32, device=device),
          "collided": torch.zeros(B, dtype=torch.bool, device=device),
          "success": torch.zeros(B, dtype=torch.bool, device=device),
          "active": torch.ones(B, dtype=torch.bool, device=device),
          "route_pos": states.route_pos.clone()}


def accumulate(m, old_state, new, active):
  del old_state
  collided = (new.collision > 0.0) & active
  arrived = common.arrived(new) & active
  stopped = (new.hero_speed < common.STOPPED_MPS) & active
  return {"steps": m["steps"] + active.to(torch.int32),
          "stopped_steps": m["stopped_steps"] + stopped.to(torch.int32),
          "collided": m["collided"] | collided,
          "success": m["success"] | arrived,
          "active": active & ~collided & ~arrived,
          "route_pos": torch.where(active, new.route_pos, m["route_pos"])}


def outcomes(m) -> np.ndarray:
  """Each episode's outcome: success, collision or timeout."""
  return np.where(m["success"], "success",
                  np.where(m["collided"], "collision", "timeout"))


def run(town: str = "Town02", episodes: int = 3, horizon: int = 1500,
        device="cuda") -> dict:
  """The rollout and its classes: ``m`` (numpy), the task ``ids``, each
  episode's ``outcome``, ``progress``, ``stopped_frac`` and
  ``dist_left``, and the NPCs' ``stalled_npc`` fraction at the end."""
  from oatomobile_torch.benchmarks.corl2017.benchmark import _TASKS  # pylint: disable=import-outside-toplevel
  tasks = {t: c for t, c in _TASKS.items() if c["town"] == town}
  ids = sorted(tasks)
  params, states = common.scenes(town, [tasks[t] for t in ids], episodes,
                                 seed=0, device=device)
  m, final = common.run(params, states, common.autopilot, accumulate,
                        initial(states), horizon, device)
  m = common.host(m)
  progress = m["route_pos"] / np.maximum(final.route_len.numpy(), 1)
  dist_left = np.linalg.norm(final.hero_xy.numpy() -
                             final.destination_xy.numpy(), axis=-1)
  stalled_npc = float(np.mean((final.npc_speed.numpy() < common.STOPPED_MPS)
                              & final.npc_alive.numpy()))
  return {"town": town, "ids": ids, "episodes": episodes, "horizon": horizon,
          "m": m, "outcome": outcomes(m), "progress": progress,
          "stopped_frac": m["stopped_steps"] / np.maximum(m["steps"], 1),
          "dist_left": dist_left, "stalled_npc": stalled_npc}


def rows(r: dict) -> list:
  """One row per episode, as the JAX script's ``--out`` writes them."""
  T = len(r["ids"])
  return [{"task": r["ids"][j % T], "episode": j // T,
           "outcome": str(r["outcome"][j]),
           "progress": float(r["progress"][j]),
           "stopped_frac": float(r["stopped_frac"][j]),
           "dist_left": float(r["dist_left"][j]),
           "steps": int(r["m"]["steps"][j])}
          for j in range(T * r["episodes"])]


def report(r: dict) -> list:
  ids, E = r["ids"], r["episodes"]
  T, outcome = len(ids), r["outcome"]
  progress, stopped_frac = r["progress"], r["stopped_frac"]
  dist_left = r["dist_left"]
  lines = ["{}: {} tasks x {} episodes".format(r["town"], T, E)]
  for cls in OUTCOMES:
    sel = outcome == cls
    n = int(sel.sum())
    if n == 0:
      lines.append("  {:9s}: 0".format(cls))
      continue
    lines.append("  {:9s}: {:4d} ({:5.1%})  progress {:5.1%}  stopped-frac "
                 "{:5.1%}  dist-left {:6.1f} m".format(
                     cls, n, n / len(outcome), np.mean(progress[sel]),
                     np.mean(stopped_frac[sel]), np.mean(dist_left[sel])))
  lines.append("  NPC stalled fraction at t={}: {:5.1%}".format(
      r["horizon"], r["stalled_npc"]))
  # Timeouts in detail: by stopped fraction and progress, the worst tasks.
  sel = outcome == "timeout"
  if sel.sum():
    per_task = collections.Counter()
    for e in range(E):
      for i, tid in enumerate(ids):
        if sel[e * T + i]:
          per_task[tid] += 1
    lines.append("  worst timeout tasks: {}".format(
        per_task.most_common(15)))
    hi_stop = sel & (stopped_frac > 0.5)
    lines.append("  timeouts mostly-parked (>50% steps stopped): "
                 "{}/{}".format(int(hi_stop.sum()), int(sel.sum())))
    slow = sel & (stopped_frac <= 0.5)
    if slow.sum():
      lines.append("  timeouts while moving: n={} mean progress {:5.1%} "
                   "mean dist-left {:6.1f} m".format(
                       int(slow.sum()), np.mean(progress[slow]),
                       np.mean(dist_left[slow])))
  return lines


def main(argv=None) -> None:
  ap = common.parser(__doc__.splitlines()[0])
  ap.add_argument("--town", default="Town02")
  ap.add_argument("--episodes", type=int, default=3)
  ap.add_argument("--horizon", type=int, default=1500)
  ap.add_argument("--out", default=None)
  args = ap.parse_args(argv)
  r = run(args.town, args.episodes, args.horizon, common.device_of(args))
  print("\n".join(report(r)))
  if args.out:
    with open(args.out, "w") as fp:
      json.dump(rows(r), fp, indent=1)
    print("wrote", args.out)


if __name__ == "__main__":
  main()
