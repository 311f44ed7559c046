"""Census of NPC stalls on CoRL2017 FullTown tasks (100 vehicles): are
stalled NPCs churning (queues that drain) or permanent knots (gridlock),
and where do they sit?  Port of the JAX package's
``scripts/diag_stalls.py``.

    python -m oatomobile_torch.experiments.diag.stalls [--cpu]
        [--town Town02] [--scenes 32] [--horizon 1500]

Tracks each NPC's consecutive-stall streak through the rollout and
reports the streak distribution, the junction occupancy of long
stallers and the red-light share, and correlates the hero's stopped time
with its proximity to a long-stalled NPC.
"""

import torch

from oatomobile_torch.experiments.diag import common
from oatomobile_torch.sim import traffic
from oatomobile_torch.sim.util import norm

# A streak longer than this (15 s at 20 Hz) makes a knot.
KNOT_STEPS = 300
THRESHOLDS = (100, 300, 600, 1000, 1400)


def initial(batch_size: int, num_npcs: int, device) -> dict:
  def z(*shape):
    return torch.zeros(shape, dtype=torch.int32, device=device)

  B, K = batch_size, num_npcs
  return {"streak": z(B, K), "max_streak": z(B, K), "stall_steps": z(B, K),
          "red_stall_steps": z(B, K), "hero_stopped": z(B),
          "hero_stopped_near_knot": z(B)}


def make_accumulate(params):
  def accumulate(m, old_state, new, active):
    del old_state, active
    stalled = (new.npc_speed < common.STOPPED_MPS) & new.npc_alive
    streak = torch.where(stalled, m["streak"] + 1, 0)
    # The red-light share of the stalls.
    tl = traffic.traffic_light_states(params, new.time)       # [B, L]
    wp_tl = params.map["wp_tl"][new.npc_wp.long()]
    light = torch.gather(tl, 1, torch.clamp(wp_tl, 0, tl.shape[1] - 1).long())
    at_red = (wp_tl >= 0) & (light != traffic.TL_GREEN)
    hero_stopped = new.hero_speed < common.STOPPED_MPS
    # The hero near a long-stalled NPC?
    long_stall = m["streak"] > KNOT_STEPS
    d_hero = norm(new.npc_xy - new.hero_xy[:, None])
    near_knot = torch.any(long_stall & (d_hero < 25.0) & new.npc_alive,
                          dim=-1)
    return {
        "streak": streak,
        "max_streak": torch.maximum(m["max_streak"], streak),
        "stall_steps": m["stall_steps"] + stalled.to(torch.int32),
        "red_stall_steps": m["red_stall_steps"] +
                           (stalled & at_red).to(torch.int32),
        "hero_stopped": m["hero_stopped"] + hero_stopped.to(torch.int32),
        "hero_stopped_near_knot": m["hero_stopped_near_knot"] +
                                  (hero_stopped & near_knot).to(torch.int32),
    }

  return accumulate


def task_configs(town: str, scenes: int):
  """(ids, configs): the first ``scenes`` CoRL2017 FullTown tasks of
  ``town``."""
  from oatomobile_torch.benchmarks.corl2017.benchmark import _TASKS  # pylint: disable=import-outside-toplevel
  tasks = {t: c for t, c in _TASKS.items()
           if c["town"] == town and "FullTown" in t}
  ids = sorted(tasks)[:scenes]
  return ids, [tasks[t] for t in ids]


def run(town: str = "Town02", scenes: int = 32, horizon: int = 1500,
        device="cuda") -> dict:
  """The rollout and the census: ``m`` (the accumulators, numpy), the
  final NPCs' ``alive`` mask and the shares ``report`` prints."""
  _, configs = task_configs(town, scenes)
  params, states = common.scenes(town, configs, 1, seed=0, device=device)
  B, K = states.batch_size, states.num_npcs
  m, final = common.run(params, states, common.autopilot,
                        make_accumulate(params),
                        initial(B, K, states.hero_xy.device), horizon,
                        device, freeze=False)
  m = common.host(m)
  alive = final.npc_alive.numpy()
  streak, max_streak = m["streak"][alive], m["max_streak"][alive]
  stall, red = m["stall_steps"][alive], m["red_stall_steps"][alive]
  perm = m["streak"] > 2 * KNOT_STEPS
  at_j = params.map["wp_is_junction"].cpu().numpy()[final.npc_wp.numpy()]
  hs = m["hero_stopped"].astype(float)
  hk = m["hero_stopped_near_knot"].astype(float)
  return {
      "town": town, "scenes": B, "horizon": horizon, "m": m,
      "alive": int(alive.sum()), "npcs": int(alive.size),
      "stall_fraction": stall.mean() / horizon,
      "red_share": red.sum() / max(stall.sum(), 1),
      "stalled_now": (streak > 0).mean(),
      "streaks": {thr: ((streak > thr).mean(), (max_streak > thr).mean())
                  for thr in THRESHOLDS},
      "permanent_at_junction": (
          (perm & at_j & alive).sum() / max((perm & alive).sum(), 1)
          if perm[alive].sum() else None),
      "hero_stopped": hs.mean() / horizon,
      "hero_near_knot": hk.sum() / max(hs.sum(), 1),
  }


def report(r: dict) -> list:
  H = r["horizon"]
  lines = [
      "{} FullTown x {} scenes, horizon {}".format(r["town"], r["scenes"], H),
      "  alive NPCs: {} / {}".format(r["alive"], r["npcs"]),
      "  mean stall fraction: {:5.1%} (red-light share of stalled steps: "
      "{:5.1%})".format(r["stall_fraction"], r["red_share"]),
      "  stalled RIGHT NOW (end): {:5.1%}".format(r["stalled_now"])]
  for thr, (now, ever) in r["streaks"].items():
    lines.append("  streak > {:4d} steps ({:4.0f}s): now {:5.1%}  ever "
                 "{:5.1%}".format(thr, thr / 20, now, ever))
  if r["permanent_at_junction"] is not None:
    lines.append("  permanent (>30s now) stallers at junction-wp: "
                 "{:5.1%}".format(r["permanent_at_junction"]))
  lines.append("  hero stopped steps: mean {:5.1%}; of those, near a "
               ">15s-stalled NPC: {:5.1%}".format(r["hero_stopped"],
                                                  r["hero_near_knot"]))
  return lines


def main(argv=None) -> None:
  ap = common.parser(__doc__.splitlines()[0])
  ap.add_argument("--town", default="Town02")
  ap.add_argument("--scenes", type=int, default=32)
  ap.add_argument("--horizon", type=int, default=1500)
  args = ap.parse_args(argv)
  print("\n".join(report(run(args.town, args.scenes, args.horizon,
                             common.device_of(args)))))


if __name__ == "__main__":
  main()
