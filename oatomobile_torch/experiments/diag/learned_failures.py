"""Failure taxonomy of a learned agent.  Port of the JAX package's
``scripts/diag_learned_failures.py``.

    python -m oatomobile_torch.experiments.diag.learned_failures [--cpu]
        --policy rip_wcm --suite corl2017 --town Town01 --episodes 2
        [--horizon 1500] [--ckpt-root DIR] [--max-tasks N] [--out FILE]
        [--bridge JSON]

Re-runs a trained policy (autopilot, dim, rip_wcm / rip_ma / rip_bcm or
cil) on a suite and classifies every episode's outcome at the step it
happens:

  - success / collision / timeout;
  - the collision's kind: NPC vehicle, pedestrian or static geometry (the
    three branches of ``sim/events.detect_collision`` re-applied to the
    state after the step), the hero's speed, junction or not, route
    progress;
  - for timeouts: the route progress at the horizon and the fraction of
    steps spent standing (speed < 0.3 m/s).

Checkpoints under ``--ckpt-root`` (default ``RUN_OUT``): the K = 4
ensemble in ``rip/ckpts`` (DIM is member 0) and CIL in ``cil/ckpts``, the
port's ``.pt`` files or the JAX package's ``.flax`` files.
"""

import collections
import json
import os

import numpy as np
import torch

from oatomobile_torch.experiments import pipeline
from oatomobile_torch.experiments.diag import common
from oatomobile_torch.ops import bev as bev_ops
from oatomobile_torch.sim.events import _obb_axes, hero_corners, obb_overlap

# The JAX script reads an ensemble of four.
NUM_MODELS = 4


def collision_kind(params, state):
  """[B] (npc_hit, ped_hit, static_hit) of each scene's state."""
  B = state.batch_size
  device = state.hero_xy.device
  half = torch.stack([params.vehicle.length / 2.0,
                      params.vehicle.width / 2.0])
  xy, yaw = state.hero_xy, state.hero_yaw

  npc_hit = torch.zeros(B, dtype=torch.bool, device=device)
  if state.num_npcs > 0:
    overlap = obb_overlap(xy[:, None, :], yaw[:, None], half[None, None, :],
                          state.npc_xy, state.npc_yaw,
                          half.expand(B, state.num_npcs, 2))
    npc_hit = torch.any(overlap & state.npc_alive, dim=-1)

  ped_hit = torch.zeros(B, dtype=torch.bool, device=device)
  if state.num_pedestrians > 0:
    fwd, right = _obb_axes(yaw)
    rel = state.ped_xy - xy[:, None, :]
    du = torch.abs(rel[..., 0] * fwd[:, None, 0] +
                   rel[..., 1] * fwd[:, None, 1])
    dv = torch.abs(rel[..., 0] * right[:, None, 0] +
                   rel[..., 1] * right[:, None, 1])
    ped_hit = torch.any((du <= half[0] + 0.35) & (dv <= half[1] + 0.35) &
                        state.ped_alive, dim=-1)

  corners = hero_corners(params, xy, yaw)                     # [B, 4, 2]
  roads = bev_ops.nearest_rects(params.map["road_rects"], xy,
                                min(12, params.road_budget),
                                max_range=100.0)              # [B, k, 6]
  dx = corners[:, :, 0, None] - roads[:, None, :, 0]
  dy = corners[:, :, 1, None] - roads[:, None, :, 1]
  u = roads[:, None, :, 4] * dx + roads[:, None, :, 5] * dy
  v = -roads[:, None, :, 5] * dx + roads[:, None, :, 4] * dy
  inside = ((u.abs() <= roads[:, None, :, 2] + 2.0) &
            (v.abs() <= roads[:, None, :, 3] + 2.0))
  static_hit = torch.any(~torch.any(inside, dim=-1), dim=-1)
  return npc_hit, ped_hit, static_hit


def initial(batch_size: int, device) -> dict:
  def z(dtype):
    return torch.zeros(batch_size, dtype=dtype, device=device)

  return {
      "active": torch.ones(batch_size, dtype=torch.bool, device=device),
      "success": z(torch.bool), "collided": z(torch.bool),
      "fail_step": torch.full((batch_size,), -1, dtype=torch.int32,
                              device=device),
      "impact_speed": z(torch.float32), "impact_npc": z(torch.bool),
      "impact_ped": z(torch.bool), "impact_static": z(torch.bool),
      "impact_junction": z(torch.bool), "impact_progress": z(torch.float32),
      "final_progress": z(torch.float32), "stalled": z(torch.int32),
      "steps": z(torch.int32),
  }


def make_accumulate(params):
  def accumulate(m, old_state, new, active):
    collided = (new.collision > 0.0) & active
    arrived = common.arrived(new) & active
    npc, ped, sta = collision_kind(params, new)
    first = collided & (m["fail_step"] < 0)
    progress = new.route_pos / torch.clamp_min(new.route_len, 1)
    in_junc = params.map["wp_is_junction"][new.hero_wp.long()]
    return {
        "active": active & ~collided & ~arrived,
        "success": m["success"] | arrived,
        "collided": m["collided"] | collided,
        "fail_step": torch.where(first, m["steps"], m["fail_step"]),
        # The policy leaves the speed as it was: this is the speed the
        # world step started from.
        "impact_speed": torch.where(first, old_state.hero_speed,
                                    m["impact_speed"]),
        "impact_npc": torch.where(first, npc, m["impact_npc"]),
        "impact_ped": torch.where(first, ped, m["impact_ped"]),
        "impact_static": torch.where(first, sta & ~npc & ~ped,
                                     m["impact_static"]),
        "impact_junction": torch.where(first, in_junc,
                                       m["impact_junction"]),
        "impact_progress": torch.where(first, progress,
                                       m["impact_progress"]),
        "final_progress": torch.where(active, progress,
                                      m["final_progress"]),
        "stalled": m["stalled"] + (
            (new.hero_speed < common.STOPPED_MPS) & active).to(torch.int32),
        "steps": m["steps"] + active.to(torch.int32),
    }

  return accumulate


def build_policy(name: str, ckpt_root: str, bridge: dict, device="cuda"):
  """The batched policy ``name`` from the checkpoints under
  ``ckpt_root``: the autopilot, DIM (ensemble member 0, 20 plan steps),
  RIP over the K = NUM_MODELS ensemble (``rip_<algorithm>``, 20 plan
  steps) or CIL, each learned one with ``bridge``."""
  if name == "autopilot":
    return common.autopilot
  factories = pipeline.policies(out=ckpt_root, num_models=NUM_MODELS,
                                bridge=bridge, device=device)
  if name.startswith("rip_") and name not in factories:
    raise ValueError("no RIP aggregation {!r}".format(name))
  return factories[name]()


def suite_tasks(suite: str, town: str, max_tasks: int = 0) -> dict:
  """The suite's tasks in ``town`` ("all": every town), sorted, the first
  ``max_tasks`` (0: all)."""
  tasks = pipeline.suites()[suite]
  tasks = {t: c for t, c in sorted(tasks.items())
           if town in ("all", c["town"])}
  if max_tasks:
    tasks = dict(list(tasks.items())[:max_tasks])
  return tasks


def rollout(policy, town: str, configs, episodes: int, horizon: int,
            device="cuda") -> dict:
  """One town's scenes (seed 7) through ``policy``: the accumulators as
  numpy arrays."""
  params, states = common.scenes(town, configs, episodes, seed=7,
                                 device=device)
  m, _ = common.run(params, states, policy, make_accumulate(params),
                    initial(states.batch_size, states.hero_xy.device),
                    horizon, device)
  return common.host(m)


def run(policy: str = "rip_wcm", suite: str = "corl2017",
        town: str = "Town01", episodes: int = 2, horizon: int = 1500,
        ckpt_root: str = None, max_tasks: int = 0, bridge: dict = None,
        device="cuda") -> dict:
  """Every episode's row (the accumulators but ``active``, in key order,
  with its ``task`` and ``episode``) under ``rows``."""
  if ckpt_root is None:
    ckpt_root = os.environ.get("RUN_OUT", pipeline.default_out("r4"))
  bridge = json.loads(pipeline.BRIDGE) if bridge is None else bridge
  tasks = suite_tasks(suite, town, max_tasks)
  fn = build_policy(policy, ckpt_root, bridge, device)
  by_town = collections.defaultdict(list)
  for t, c in tasks.items():
    by_town[c["town"]].append((t, c))
  rows = []
  for town_name, group in sorted(by_town.items()):
    ids = [t for t, _ in group]
    m = rollout(fn, town_name, [c for _, c in group], episodes, horizon,
                device)
    T = len(group)
    for e in range(episodes):
      for i, task_id in enumerate(ids):
        j = e * T + i
        rows.append({k: m[k][j].item() for k in sorted(m) if k != "active"}
                    | {"task": task_id, "episode": e})
  return {"policy": policy, "suite": suite, "town": town, "rows": rows}


def report(r: dict) -> list:
  rows = r["rows"]
  n = len(rows)
  succ = [x for x in rows if x["success"]]
  coll = [x for x in rows if x["collided"]]
  tout = [x for x in rows if not x["success"] and not x["collided"]]
  lines = ["{} on {}/{}: {} episodes".format(r["policy"], r["suite"],
                                             r["town"], n),
           "  success {:6.1%}   collision {:6.1%}   timeout {:6.1%}".format(
               len(succ) / n, len(coll) / n, len(tout) / n)]
  if coll:
    kinds = collections.Counter(
        "npc" if x["impact_npc"] else
        "pedestrian" if x["impact_ped"] else
        "static" if x["impact_static"] else "resolved-away" for x in coll)
    lines.append("  collision kinds: {}".format(dict(kinds)))
    lines.append(
        "  at junction: {:.1%} | mean impact speed {:.2f} m/s | mean route "
        "progress {:.1%} | median fail step {}".format(
            np.mean([x["impact_junction"] for x in coll]),
            np.mean([x["impact_speed"] for x in coll]),
            np.mean([x["impact_progress"] for x in coll]),
            int(np.median([x["fail_step"] for x in coll]))))
    slow = [x for x in coll if x["impact_speed"] < 1.0]
    lines.append("  collisions while hero nearly stopped (<1 m/s): {:.1%}  "
                 "(rear-ended / rammed while queueing)".format(
                     len(slow) / len(coll)))
  if tout:
    lines.append("  timeouts: mean final progress {:.1%} | mean stall "
                 "fraction {:.1%}".format(
                     np.mean([x["final_progress"] for x in tout]),
                     np.mean([x["stalled"] / max(x["steps"], 1)
                              for x in tout])))
  return lines


def main(argv=None) -> None:
  ap = common.parser(__doc__.splitlines()[0])
  ap.add_argument("--policy", default="rip_wcm")
  ap.add_argument("--suite", default="corl2017",
                  choices=["corl2017", "carnovel"])
  ap.add_argument("--town", default="Town01")
  ap.add_argument("--episodes", type=int, default=2)
  ap.add_argument("--horizon", type=int, default=1500)
  ap.add_argument("--ckpt-root", default=None,
                  help="default: RUN_OUT")
  ap.add_argument("--max-tasks", type=int, default=0)
  ap.add_argument("--out", default="")
  ap.add_argument("--bridge", default=pipeline.BRIDGE)
  args = ap.parse_args(argv)
  r = run(args.policy, args.suite, args.town, args.episodes, args.horizon,
          args.ckpt_root, args.max_tasks, json.loads(args.bridge),
          common.device_of(args))
  print("\n".join(report(r)))
  if args.out:
    with open(args.out, "w") as fp:
      json.dump(r["rows"], fp, indent=1)
    print("wrote", args.out)


if __name__ == "__main__":
  main()
