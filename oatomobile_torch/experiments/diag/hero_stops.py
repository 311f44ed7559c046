"""Decompose the hero's stopped time on CoRL2017 tasks into its causes:
red light, hard stop (crossing mover / intercept), queue-follow envelope,
box hold, end of route, by re-running the autopilot's hazard tests
against the rollout states.  Port of the JAX package's
``scripts/diag_hero_stops.py``.

    python -m oatomobile_torch.experiments.diag.hero_stops [--cpu]
        [--town Town02] [--scenes 32] [--horizon 1500]
"""

import torch

from oatomobile_torch.experiments.diag import common
from oatomobile_torch.sim import traffic
from oatomobile_torch.sim.autopilot import _red_light_hazard, _route_window
from oatomobile_torch.sim.util import hypot, norm, take

KEYS = ("red", "hard", "queue", "box", "at_end", "leader_moving")


def hero_stop_causes(params, state):
  """[B] flags of each cause, the JAX script's mirror of the autopilot's
  hazard decomposition (its rules as the script wrote them, which the
  autopilot has since refined)."""
  tl_states = traffic.traffic_light_states(params, state.time)
  red = _red_light_hazard(params, state, tl_states)

  rel = state.npc_xy - state.hero_xy[:, None, :]              # [B, K, 2]
  dist = norm(rel)
  cos_y = torch.cos(state.hero_yaw)[:, None]
  sin_y = torch.sin(state.hero_yaw)[:, None]
  fwd = cos_y * rel[..., 0] + sin_y * rel[..., 1]
  moving = state.npc_speed > 0.5
  path_wp = take(state.route, _route_window(state, 1, 8)).long()
  path_xy = params.map["wp_xy"][path_wp]                      # [B, 7, 2]
  rel_p = path_xy[:, None, :, :] - state.npc_xy[:, :, None, :]
  cn = torch.cos(state.npc_yaw)[..., None]
  sn = torch.sin(state.npc_yaw)[..., None]
  px = cn * rel_p[..., 0] + sn * rel_p[..., 1]
  py = -sn * rel_p[..., 0] + cn * rel_p[..., 1]
  dxp = torch.clamp_min(px.abs() - params.vehicle.length / 2.0, 0.0)
  dyp = torch.clamp_min(py.abs() - params.vehicle.width / 2.0, 0.0)
  on_my_path = torch.any(hypot(dxp, dyp) < 1.6, dim=-1) & (fwd > -1.0)
  hero_wp, npc_wp = state.hero_wp.long(), state.npc_wp.long()
  road, lane = params.map["wp_road_id"], params.map["wp_lane_id"]
  same = ((road[npc_wp] == road[hero_wp][:, None]) &
          (lane[npc_wp] == lane[hero_wp][:, None]))
  lane_rule = same & (fwd > 0.0) & (dist <
                                    params.proximity_vehicle_threshold)
  blocking = (lane_rule | on_my_path) & state.npc_alive
  cos_rel = torch.cos(state.npc_yaw - state.hero_yaw[:, None])
  same_dir_npc = cos_rel > 0.5
  npc_vel = state.npc_speed[..., None] * torch.stack(
      [torch.cos(state.npc_yaw), torch.sin(state.npc_yaw)], dim=-1)
  rel_fut = rel + (npc_vel - state.hero_vel[:, None, :]) * 1.0
  fwd_f = cos_y * rel_fut[..., 0] + sin_y * rel_fut[..., 1]
  lat = -sin_y * rel[..., 0] + cos_y * rel[..., 1]
  lat_f = -sin_y * rel_fut[..., 0] + cos_y * rel_fut[..., 1]
  intercept = ((fwd_f > -1.0) & (fwd_f < 8.0) & (lat_f.abs() < 2.5) &
               moving)
  oncoming = cos_rel < -0.5
  oncoming_passer = (oncoming & moving & (lat.abs() > 1.2) &
                     (lat_f.abs() > 1.0))
  follow_target = (blocking & ~moving) | (blocking & moving & same_dir_npc)
  d_q = torch.amin(torch.where(follow_target, dist, 1e9), dim=-1)
  speed = state.hero_speed
  queue_stop = (speed * speed > 2.0 * 2.0 * torch.clamp_min(d_q - 6.0, 0.0)
                ) | (d_q < 6.0)
  junction = params.map["wp_is_junction"]
  box_hold = (~junction[hero_wp] & torch.any(junction[path_wp], dim=-1) &
              torch.any(blocking & ~moving, dim=-1))
  hard = torch.any((blocking & moving & ~same_dir_npc) |
                   (intercept & ~oncoming_passer & state.npc_alive), dim=-1)
  at_end = state.route_pos >= state.route_len - 3
  # Is the queue's leader itself moving?
  leader_moving = torch.any(follow_target & moving &
                            (dist < d_q[:, None] + 0.5), dim=-1)
  return {"red": red, "hard": hard, "queue": queue_stop, "box": box_hold,
          "at_end": at_end, "leader_moving": leader_moving & queue_stop}


def initial(batch_size: int, device) -> dict:
  def z(dtype=torch.int32):
    return torch.zeros(batch_size, dtype=dtype, device=device)

  m = {k: z() for k in KEYS + ("stopped", "moving_steps")}
  m["moving_speed"] = z(torch.float32)
  m["active"] = torch.ones(batch_size, dtype=torch.bool, device=device)
  return m


def make_accumulate(params):
  def accumulate(m, old_state, new_state, active):
    del old_state, active
    active = (m["active"] & ~common.arrived(new_state) &
              ~(new_state.collision > 0))
    causes = hero_stop_causes(params, new_state)
    stopped = (new_state.hero_speed < common.STOPPED_MPS) & active
    moving = ~stopped & active
    out = {k: m[k] + (stopped & causes[k]).to(torch.int32) for k in KEYS}
    out["stopped"] = m["stopped"] + stopped.to(torch.int32)
    out["moving_speed"] = m["moving_speed"] + torch.where(
        moving, new_state.hero_speed, 0.0)
    out["moving_steps"] = m["moving_steps"] + moving.to(torch.int32)
    out["active"] = active
    return out

  return accumulate


def task_configs(town: str, scenes: int):
  """(ids, configs): the first ``scenes`` CoRL2017 tasks of ``town``."""
  from oatomobile_torch.benchmarks.corl2017.benchmark import _TASKS  # pylint: disable=import-outside-toplevel
  tasks = {t: c for t, c in _TASKS.items() if c["town"] == town}
  ids = sorted(tasks)[:scenes]
  return ids, [tasks[t] for t in ids]


def run(town: str = "Town02", scenes: int = 32, horizon: int = 1500,
        device="cuda", *, eager: bool = False) -> dict:
  """The rollout and its shares: ``m`` (the accumulators, numpy),
  ``stopped_share`` of all steps, each cause's share of the stopped
  steps (``shares``) and ``mean_moving_speed``.  ``eager`` runs the plain
  loop in place of the captured step."""
  _, configs = task_configs(town, scenes)
  params, states = common.scenes(town, configs, 1, seed=0, device=device)
  B = states.batch_size
  args = (params, states, common.autopilot, make_accumulate(params),
          initial(B, states.hero_xy.device), horizon)
  if eager:
    m, _ = common.run_eager(*args, freeze=False)
  else:
    m, _ = common.run(*args, device=device, freeze=False)
  m = common.host(m)
  stopped = m["stopped"].astype(float)
  tot = max(stopped.sum(), 1.0)
  return {
      "town": town, "scenes": B, "horizon": horizon, "m": m,
      "stopped_share": stopped.sum() / (B * horizon),
      "shares": {k: m[k].astype(float).sum() / tot for k in KEYS},
      "mean_moving_speed": (m["moving_speed"].sum() /
                            max(m["moving_steps"].sum(), 1)),
  }


def report(r: dict) -> list:
  lines = ["{} x {} scenes: hero stopped {:5.1%} of all steps".format(
      r["town"], r["scenes"], r["stopped_share"])]
  for k in KEYS:
    lines.append("  {:14s}: {:5.1%} of stopped steps".format(
        k, r["shares"][k]))
  lines.append("  mean speed while moving: {:.2f} m/s".format(
      r["mean_moving_speed"]))
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
