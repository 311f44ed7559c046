"""Classify the autopilot's CARNOVEL Hills collisions (Town03, 100
vehicles).  Port of the JAX package's ``scripts/diag_hills.py``.

    python -m oatomobile_torch.experiments.diag.hills [--cpu]
        [--episodes 10] [--horizon 1500] [--family Hills]

For every collision episode it snapshots the geometry just before the
colliding step (the nearest NPC in the hero frame, the relative heading,
the speeds, junction membership, the route's bend) and buckets the
crashes: rear-end / sideswipe (same direction), T-bone (crossing),
head-on.
"""

import numpy as np
import torch

from oatomobile_torch.experiments.diag import common
from oatomobile_torch.sim.util import norm, take


def snapshot(params, state) -> dict:
  """[B] geometry of each scene's closest alive NPC, in the hero frame."""
  rel = state.npc_xy - state.hero_xy[:, None, :]              # [B, K, 2]
  dist = torch.where(state.npc_alive, norm(rel), 1e9)
  j = torch.argmin(dist, dim=-1)[:, None]
  rel_j = take(rel, j)[:, 0]                                   # [B, 2]
  cos_y, sin_y = torch.cos(state.hero_yaw), torch.sin(state.hero_yaw)
  d_yaw = take(state.npc_yaw, j)[:, 0] - state.hero_yaw
  hero_wp = state.hero_wp.long()
  return {
      "fwd": cos_y * rel_j[:, 0] + sin_y * rel_j[:, 1],
      "lat": -sin_y * rel_j[:, 0] + cos_y * rel_j[:, 1],
      "rel_yaw": torch.atan2(torch.sin(d_yaw), torch.cos(d_yaw)),
      "npc_dist": take(dist, j)[:, 0],
      "hero_speed": state.hero_speed,
      "npc_speed": take(state.npc_speed, j)[:, 0],
      "at_junction": params.map["wp_is_junction"][hero_wp],
      "bend": params.map["wp_bend"][hero_wp],
      "progress": state.route_pos / torch.clamp_min(state.route_len, 1),
      "asserting": state.hero_wait > common.ASSERT_STEPS,
  }


def initial(params, states, snap=snapshot) -> dict:
  B, device = states.batch_size, states.hero_xy.device
  return {"steps": torch.zeros(B, dtype=torch.int32, device=device),
          "collided": torch.zeros(B, dtype=torch.bool, device=device),
          "success": torch.zeros(B, dtype=torch.bool, device=device),
          "active": torch.ones(B, dtype=torch.bool, device=device),
          "crash": {k: torch.zeros_like(v)
                    for k, v in snap(params, states).items()}}


def make_accumulate(params, snap=snapshot):
  """The crash forensics: ``snap`` of the state before the step that
  first collides, latched per scene."""

  def accumulate(m, old_state, new, active):
    collided = (new.collision > 0.0) & active
    arrived = common.arrived(new) & active
    first = collided & ~m["collided"]
    snaps = snap(params, old_state)
    return {
        "steps": m["steps"] + active.to(torch.int32),
        "collided": m["collided"] | collided,
        "success": m["success"] | arrived,
        "active": active & ~collided & ~arrived,
        "crash": {k: torch.where(
            first.reshape((-1,) + (1,) * (v.dim() - 1)), v, m["crash"][k])
                  for k, v in snaps.items()},
    }

  return accumulate


def family_scenes(family: str, episodes: int, device):
  """(ids, town, params, states) of a one-town CARNOVEL family (seed
  7)."""
  ids = common.carnovel_ids(family)
  from oatomobile_torch.benchmarks.carnovel.benchmark import _TASKS  # pylint: disable=import-outside-toplevel
  towns = {_TASKS[t]["town"] for t in ids}
  if len(towns) != 1:
    raise ValueError("{} spans towns {}".format(family, sorted(towns)))
  return (ids, *common.carnovel_scenes(ids, episodes, 7, device))


def run(episodes: int = 10, horizon: int = 1500, family: str = "Hills",
        device="cuda") -> dict:
  """The rollout: ``m`` (numpy, the crash snapshots under ``crash``) and
  the task ``ids``."""
  ids, _, params, states = family_scenes(family, episodes, device)
  m, _ = common.run(params, states, common.autopilot,
                    make_accumulate(params), initial(params, states),
                    horizon, device)
  return {"family": family, "ids": ids, "episodes": episodes,
          "horizon": horizon, "m": common.host(m)}


def classes(c: dict) -> dict:
  """The crash buckets over the collided episodes' snapshots ``c``."""
  rel_yaw = np.abs(c["rel_yaw"])
  same_dir = rel_yaw < np.pi / 4
  head_on = rel_yaw > 3 * np.pi / 4
  crossing = ~same_dir & ~head_on
  behind = c["fwd"] < -1.0
  side = np.abs(c["lat"]) > 1.0
  return {
      "rear-end (same-dir, ahead, centered)": same_dir & ~behind & ~side,
      "sideswipe same-dir (lat>1)": same_dir & side,
      "hit-from-behind (npc behind hero)": behind,
      "T-bone / crossing": crossing & ~behind,
      "head-on": head_on & ~behind & ~side,
      "head-on offset (side)": head_on & ~behind & side,
  }


def report(r: dict) -> str:
  m, ids, E = r["m"], r["ids"], r["episodes"]
  T = len(ids)
  coll, succ = m["collided"], m["success"]
  lines = ["{}: {} tasks x {} eps = {}  success {:.1%}  collision {:.1%}  "
           "timeout {:.1%}".format(r["family"], T, E, len(coll), succ.mean(),
                                   coll.mean(),
                                   1 - succ.mean() - coll.mean())]
  c = {k: v[coll] for k, v in m["crash"].items()}
  lines.append("\ncollisions: {}".format(coll.sum()))
  for name, sel in classes(c).items():
    k = int(sel.sum())
    if not k:
      continue
    lines.append(
        "  {:38s}: {:3d} ({:5.1%})  hero_v {:4.1f}  npc_v {:4.1f}  junction "
        "{:4.1%}  bend {:5.2f}  asserting {:4.1%}  progress {:5.1%}".format(
            name, k, k / max(coll.sum(), 1), c["hero_speed"][sel].mean(),
            c["npc_speed"][sel].mean(), c["at_junction"][sel].mean(),
            c["bend"][sel].mean(), c["asserting"][sel].mean(),
            c["progress"][sel].mean()))
  task_ids = np.tile(np.arange(T), E)
  lines.append("")
  for i, tid in enumerate(ids):
    sel = task_ids == i
    lines.append("  {:20s} succ {:5.1%} coll {:5.1%}".format(
        tid, succ[sel].mean(), coll[sel].mean()))
  return "\n".join(lines)


def main(argv=None) -> None:
  ap = common.parser(__doc__.splitlines()[0])
  ap.add_argument("--episodes", type=int, default=10)
  ap.add_argument("--horizon", type=int, default=1500)
  ap.add_argument("--family", default="Hills")
  args = ap.parse_args(argv)
  print(report(run(args.episodes, args.horizon, args.family,
                   common.device_of(args))))


if __name__ == "__main__":
  main()
