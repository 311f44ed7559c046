"""Decompose CARNOVEL BusyTown timeouts: per-outcome stopped-time causes
by the autopilot's own hazard tests (imported, not mirrored), and a
gridlock census of the NPCs around the hero.  Port of the JAX package's
``scripts/diag_busytown.py``.

    python -m oatomobile_torch.experiments.diag.busytown [--cpu]
        [--episodes 10] [--horizon 1500] [--family BusyTown]

The scenes are built in the family's first task's town, as the JAX
script builds them.
"""

import numpy as np
import torch

from oatomobile_torch.experiments.diag import common
from oatomobile_torch.sim import traffic
from oatomobile_torch.sim.autopilot import _red_light_hazard, _vehicle_hazard
from oatomobile_torch.sim.util import norm

KEYS = ("red", "mover", "assert_creep", "static")


def causes(params, state) -> dict:
  tls = traffic.traffic_light_states(params, state.time)
  mover, _, static, _, _, _ = _vehicle_hazard(params, state)
  red = _red_light_hazard(params, state, tls)
  asserting = state.hero_wait > common.ASSERT_STEPS
  near_stalled = ((norm(state.npc_xy - state.hero_xy[:, None]) < 25.0) &
                  state.npc_alive & (state.npc_speed < common.STOPPED_MPS))
  return {"red": red, "mover": mover & ~asserting,
          "assert_creep": asserting & mover, "static": static,
          "near_stalled": near_stalled.sum(-1, dtype=torch.int32)}


def initial(states) -> dict:
  B, device = states.batch_size, states.hero_xy.device
  m = {k: torch.zeros(B, dtype=torch.int32, device=device) for k in KEYS}
  m.update(stopped=torch.zeros(B, dtype=torch.int32, device=device),
           near_stalled=torch.zeros(B, dtype=torch.int32, device=device),
           collided=torch.zeros(B, dtype=torch.bool, device=device),
           success=torch.zeros(B, dtype=torch.bool, device=device),
           active=torch.ones(B, dtype=torch.bool, device=device),
           route_pos=states.route_pos.clone())
  return m


def make_accumulate(params):
  def accumulate(m, old_state, new, active):
    del old_state
    collided = (new.collision > 0.0) & active
    arrived = common.arrived(new) & active
    c = causes(params, new)
    stopped = (new.hero_speed < common.STOPPED_MPS) & active
    out = {k: m[k] + (stopped & c[k]).to(torch.int32) for k in KEYS}
    out.update(
        stopped=m["stopped"] + stopped.to(torch.int32),
        near_stalled=m["near_stalled"] + torch.where(stopped,
                                                     c["near_stalled"], 0),
        collided=m["collided"] | collided,
        success=m["success"] | arrived,
        active=active & ~collided & ~arrived,
        route_pos=torch.where(active, new.route_pos, m["route_pos"]))
    return out

  return accumulate


def run(episodes: int = 10, horizon: int = 1500, family: str = "BusyTown",
        device="cuda") -> dict:
  """The rollout (seed 7): ``m`` (numpy), the task ``ids``, each
  episode's ``outcome`` and ``progress``."""
  ids = common.carnovel_ids(family)
  _, params, states = common.carnovel_scenes(ids, episodes, 7, device)
  m, final = common.run(params, states, common.autopilot,
                        make_accumulate(params), initial(states), horizon,
                        device)
  m = common.host(m)
  outcome = np.where(m["success"], "success",
                     np.where(m["collided"], "collision", "timeout"))
  route_len = final.route_len.numpy().astype(float)
  return {"family": family, "ids": ids, "episodes": episodes,
          "horizon": horizon, "m": m, "outcome": outcome,
          "progress": m["route_pos"] / np.maximum(route_len, 1)}


def report(r: dict) -> str:
  m, outcome, progress = r["m"], r["outcome"], r["progress"]
  ids, E = r["ids"], r["episodes"]
  T = len(ids)
  coll, succ = m["collided"], m["success"]
  lines = ["{}: {} tasks x {} eps = {}  success {:.1%}  coll {:.1%}  "
           "timeout {:.1%}".format(r["family"], T, E, len(coll), succ.mean(),
                                   coll.mean(),
                                   (outcome == "timeout").mean())]
  stopped = m["stopped"].astype(float)
  for cls in ("success", "timeout"):
    sel = outcome == cls
    if not sel.sum():
      continue
    tot = max(stopped[sel].sum(), 1.0)
    lines.append("\n{} ({}): stopped-frac {:5.1%}  progress {:5.1%}".format(
        cls, sel.sum(), stopped[sel].mean() / r["horizon"],
        progress[sel].mean()))
    for k in KEYS:
      v = m[k].astype(float)[sel].sum()
      lines.append("  {:13s}: {:5.1%} of stopped steps".format(k, v / tot))
    ns = m["near_stalled"].astype(float)[sel].sum()
    lines.append("  stalled NPCs within 25 m while stopped (mean): "
                 "{:.1f}".format(ns / tot))
  task_ids = np.tile(np.arange(T), E)
  lines.append("")
  for i, tid in enumerate(ids):
    sel = task_ids == i
    lines.append("  {:22s} succ {:5.1%} timeout {:5.1%} progress "
                 "{:5.1%}".format(tid, succ[sel].mean(),
                                  (outcome[sel] == "timeout").mean(),
                                  progress[sel].mean()))
  return "\n".join(lines)


def main(argv=None) -> None:
  ap = common.parser(__doc__.splitlines()[0])
  ap.add_argument("--episodes", type=int, default=10)
  ap.add_argument("--horizon", type=int, default=1500)
  ap.add_argument("--family", default="BusyTown")
  args = ap.parse_args(argv)
  print(report(run(args.episodes, args.horizon, args.family,
                   common.device_of(args))))


if __name__ == "__main__":
  main()
