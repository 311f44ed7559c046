"""Autopilot expert over a scene batch.

Port of the JAX package's ``sim/autopilot.py`` (the reference's
``AutopilotAgent`` decision logic): hazard stops for vehicles and red
lights, waypoint following along the precomputed route with the
reference PID gains, patience-based yield assertion and optional
epsilon-noise.  The measurements behind each rule are documented in the
JAX module; this module ports what that code does.
"""

from typing import Tuple

import numpy as np
import torch

from perfbench.reference import threefry as rng_lib
from perfbench.reference.sim import dynamics, traffic
from perfbench.reference.sim.types import SceneState, WorldParams
from perfbench.reference.sim.util import (constant, hypot, norm, take,
                                       wrap_angle)

TARGET_SPEED_MPS = 20.0 / 3.6  # reference defaults.py:185 is in km/h.
LOOKAHEAD = 2  # route points ahead used as the steering target (~4 m).


def _route_window(state: SceneState, start: int, stop: int) -> torch.Tensor:
  """[B, stop - start] route indices ``route_pos + (start..stop-1)``
  clipped to the route."""
  offsets = torch.arange(start, stop, device=state.route.device)
  return torch.minimum(
      torch.clamp_min(state.route_pos[:, None] + offsets, 0),
      (state.route_len - 1)[:, None])


def _vehicle_hazard(params: WorldParams, state: SceneState):
  """[B] (mover_stop, graded_stop, static_stop, conflict, evade,
  near_ahead) for each hero: the reference's same-lane rule OR-ed with a
  path-aware test against the hero's upcoming route points."""
  B = state.batch_size
  if state.num_npcs == 0:
    false = torch.zeros((B,), dtype=torch.bool, device=state.hero_xy.device)
    return (false, false, false, false,
            torch.zeros((B,), dtype=torch.float32,
                        device=state.hero_xy.device), false)
  vehicle = params.vehicle
  hero_wp = state.hero_wp.long()
  hero_road = params.map["wp_road_id"][hero_wp]
  hero_lane = params.map["wp_lane_id"][hero_wp]
  npc_wp = state.npc_wp.long()
  npc_road = params.map["wp_road_id"][npc_wp]
  npc_lane = params.map["wp_lane_id"][npc_wp]
  same = (npc_road == hero_road[:, None]) & (npc_lane == hero_lane[:, None])

  rel = state.npc_xy - state.hero_xy[:, None, :]              # [B, K, 2]
  dist = norm(rel)
  cos_y = torch.cos(state.hero_yaw)[:, None]
  sin_y = torch.sin(state.hero_yaw)[:, None]
  fwd = cos_y * rel[..., 0] + sin_y * rel[..., 1]
  lat = -sin_y * rel[..., 0] + cos_y * rel[..., 1]
  ahead = fwd > 0.0
  near = dist < params.proximity_vehicle_threshold
  lane_rule = same & ahead & near

  moving = state.npc_speed > 0.5

  # Path-aware blocking: route points against each NPC's rectangle.
  path_idx = _route_window(state, 1, 8)                       # [B, 7]
  path_wp = take(state.route, path_idx).long()
  path_xy = params.map["wp_xy"][path_wp]                      # [B, 7, 2]
  rel_p = path_xy[:, None, :, :] - state.npc_xy[:, :, None, :]  # [B, K, 7, 2]
  cn = torch.cos(state.npc_yaw)[..., None]
  sn = torch.sin(state.npc_yaw)[..., None]
  px = cn * rel_p[..., 0] + sn * rel_p[..., 1]
  py = -sn * rel_p[..., 0] + cn * rel_p[..., 1]
  dxp = torch.clamp_min(px.abs() - vehicle.length / 2.0, 0.0)
  dyp = torch.clamp_min(py.abs() - vehicle.width / 2.0, 0.0)
  d_path = hypot(dxp, dyp)                                    # [B, K, 7]
  on_path_l = d_path < 1.6
  any_on_path = torch.any(on_path_l, dim=-1)
  on_my_path = any_on_path & (fwd > -1.0)

  # Intercept prediction ~1 s out, against the hero's own predicted
  # position (gap acceptance).
  npc_vel = state.npc_speed[..., None] * torch.stack(
      [torch.cos(state.npc_yaw), torch.sin(state.npc_yaw)], dim=-1)
  rel_fut = rel + (npc_vel - state.hero_vel[:, None, :]) * 1.0
  fwd_f = cos_y * rel_fut[..., 0] + sin_y * rel_fut[..., 1]
  lat_f = -sin_y * rel_fut[..., 0] + cos_y * rel_fut[..., 1]
  fwd_gap = fwd_f - state.hero_speed[:, None] * 1.0
  intercept = ((fwd_gap > -2.0) & (fwd_gap < 5.5) & (lat_f.abs() < 2.5) &
               moving)

  cos_rel = torch.cos(state.npc_yaw - state.hero_yaw[:, None])
  oncoming = cos_rel < -0.5
  oncoming_passer = (oncoming & moving & (lat.abs() > 1.2) &
                     (lat_f.abs() > 1.0))
  head_on_close = (oncoming & (fwd > 0.0) & (fwd < 7.0) &
                   (lat.abs() < 2.6) & state.npc_alive)

  # Graded following of stopped / same-direction bodies on the path.
  blocking = (lane_rule | on_my_path) & state.npc_alive
  same_dir_npc = cos_rel > 0.5
  follow_target = (blocking & ~moving) | (blocking & moving & same_dir_npc)
  d_masked = torch.where(follow_target, dist, 1e9)
  d_q = torch.amin(d_masked, dim=-1)
  v_leader = torch.where(
      d_q < 1e8,
      take(state.npc_speed, torch.argmin(d_masked, dim=-1)[:, None])[:, 0],
      0.0)
  hero_speed = state.hero_speed
  closing = hero_speed > v_leader - 0.3
  queue_stop = (hero_speed * hero_speed >
                2.0 * 2.0 * torch.clamp_min(d_q - 6.0, 0.0)) | \
      ((d_q < 6.0) & closing)
  # Don't block the box.
  is_junction = params.map["wp_is_junction"]
  box_hold = (~is_junction[hero_wp] &
              torch.any(is_junction[path_wp], dim=-1) &
              torch.any(blocking & ~moving, dim=-1))
  # Mover stops (assertable after a patient wait).
  cross_hard = blocking & moving & ~same_dir_npc
  mover_stop = torch.any(cross_hard |
                         (intercept & ~oncoming_passer & state.npc_alive),
                         dim=-1)
  # The asserting form: yield short of the first conflicted path point.
  first_l = torch.argmax(on_path_l.to(torch.int32), dim=-1)   # [B, K]
  d_path_conf = torch.where(any_on_path,
                            2.0 * (first_l.to(torch.float32) + 1.0), 1e9)
  d_cross = torch.where(cross_hard, torch.minimum(d_path_conf, dist), 1e9)
  d_hazard = torch.amin(d_cross, dim=-1)
  graded_stop = (hero_speed * hero_speed >
                 2.0 * 2.5 * torch.clamp_min(d_hazard - 4.5, 0.0)) | \
      (d_hazard < 4.5)
  static_stop = queue_stop | box_hold
  conflict = torch.any(head_on_close, dim=-1)
  evade = -torch.sign(torch.sum(
      torch.where(head_on_close, torch.sign(lat), 0.0), dim=-1))
  near_ahead = torch.any(state.npc_alive & (dist < 15.0) & (fwd > -2.0) &
                         (lat.abs() < 4.0), dim=-1)
  return mover_stop, graded_stop, static_stop, conflict, evade, near_ahead


def _red_light_hazard(params: WorldParams, state: SceneState,
                      tl_states: torch.Tensor) -> torch.Tensor:
  """[B] True where the hero's waypoint is governed by a red light within
  the light proximity threshold (EU-style stop-at-line)."""
  governed, tl_state = traffic.light_for_waypoint(params, state.hero_wp,
                                                  tl_states)
  num_lights = tl_states.shape[-1]
  if num_lights == 0:
    return torch.zeros_like(governed)
  tl_id = torch.clamp(params.map["wp_tl"][state.hero_wp.long()], 0,
                      num_lights - 1)
  tl_pos = params.map["tl_xy"][tl_id.long()]
  dist = norm(tl_pos - state.hero_xy)
  near = dist < 3.0 * params.proximity_tlight_threshold
  return governed & near & (tl_state == traffic.TL_RED)


def _max_abs_heading_change(params: WorldParams, state: SceneState,
                            idx: torch.Tensor) -> torch.Tensor:
  """[B] max |wrapped heading change| from the hero to route points."""
  yaw = params.map["wp_yaw"][take(state.route, idx).long()]
  return torch.amax(wrap_angle(yaw - state.hero_yaw[:, None]).abs(), dim=-1)


def autopilot_policy(
    params: WorldParams,
    state: SceneState,
    *,
    noise: float = 0.0,
    target_speed: float = TARGET_SPEED_MPS,
) -> Tuple[torch.Tensor, SceneState]:
  """Returns (action [B, 3], state with updated PID, patience + RNG).

  ``target_speed`` (m/s, a Python number) raises the cruise base above
  30 km/h; the waypoint's speed limit still caps it."""
  keys = rng_lib.split(state.rng, 3)
  rng, rng_noise, rng_action = keys[:, 0], keys[:, 1], keys[:, 2]
  is_junction = params.map["wp_is_junction"]
  hero_wp = state.hero_wp.long()

  tl_states = traffic.traffic_light_states(params, state.time)
  mover_stop, graded_stop, static_stop, conflict, evade, near_ahead = \
      _vehicle_hazard(params, state)
  red = _red_light_hazard(params, state, tl_states)
  # Patience-based yield assertion: after ~3 s held at a yield, creep in.
  asserting = state.hero_wait > 60
  effective_mover = torch.where(asserting, graded_stop, mover_stop)
  hazard = effective_mover | static_stop | red
  # Leaky patience: accumulate while mover-held below creep speed, pause
  # at reds/queues, decay 5x when moving.
  held = mover_stop & (state.hero_speed < 1.5) & ~static_stop & ~red
  pause = (static_stop | red) & (state.hero_speed < 1.5)
  hero_wait = torch.where(
      (asserting & mover_stop) | held,
      torch.clamp_max(state.hero_wait + 1, 100000),
      torch.where(pause, state.hero_wait,
                  torch.clamp_min(state.hero_wait - 5, 0)))

  # Steering target: a route point slightly ahead of current progress.
  target_idx = _route_window(state, LOOKAHEAD, LOOKAHEAD + 1)[:, 0]
  target_xy = params.map["wp_xy"][
      take(state.route, target_idx[:, None])[:, 0].long()]

  steer, pid_lat = dynamics.lateral_control(state.pid_lat, state.hero_xy,
                                            state.hero_yaw, target_xy,
                                            params.dt)
  # Head-on conflict: squeeze past at walking pace, steering away.
  steer = torch.clamp(steer + torch.where(conflict, 0.5 * evade, 0.0), -1.0,
                      1.0)
  # Curvature slow-down from the heading error to the target and the
  # upcoming route bend.
  to_t = target_xy - state.hero_xy
  desired = torch.atan2(to_t[:, 1], to_t[:, 0])
  err = wrap_angle(desired - state.hero_yaw).abs()
  ahead_idx = _route_window(state, 1, 7)
  bend = _max_abs_heading_change(params, state, ahead_idx)
  slow = torch.clamp(1.0 - 0.8 * torch.maximum(err, 0.7 * bend), 0.3, 1.0)
  # Long-horizon bend (~24 m) gates the fast cruise only.
  far_bend = _max_abs_heading_change(params, state, _route_window(state, 1,
                                                                  13))
  ahead_junction = torch.any(
      is_junction[take(state.route, ahead_idx).long()], dim=-1) | \
      is_junction[hero_wp]
  fast = (~ahead_junction & (far_bend < 0.15) & ~near_ahead & ~conflict)
  # Cruise: 30 km/h base, 35 km/h on clear straight junction-free road.
  cruise_base = float(max(np.float32(target_speed),
                          np.float32(30.0 / 3.6)))
  cruise = torch.where(fast, float(np.float32(35.0 / 3.6)), cruise_base)
  speed_cmd = torch.minimum(
      cruise, params.map["wp_speed_limit"][hero_wp]) * slow
  # Stop at the end of the route.
  at_end = state.route_pos >= state.route_len - 3
  speed_cmd = torch.where(at_end, 0.0, speed_cmd)
  speed_cmd = torch.where(conflict, torch.clamp_max(speed_cmd, 1.2),
                          speed_cmd)
  # Asserting through a yield: creep, don't cruise.
  speed_cmd = torch.where(asserting & mover_stop,
                          torch.clamp_max(speed_cmd, 2.0), speed_cmd)
  throttle, brake, pid_lon = dynamics.longitudinal_control_with_brake(
      state.pid_lon, state.hero_speed, speed_cmd, params.dt)

  brake_action = constant((0.0, 0.0, 1.0), throttle.device)
  action = torch.where(hazard[:, None], brake_action,
                       torch.stack([throttle, steer, brake], dim=-1))

  # Freeze PID integrators while hazard-braking (decay at CARLA's deque
  # time scale instead of winding up).
  def freeze(new, old):
    return type(new)(
        err_buf=torch.where(hazard[:, None], 0.97 * old.err_buf,
                            new.err_buf),
        prev_error=torch.where(hazard, 0.97 * old.prev_error,
                               new.prev_error))

  pid_lat = freeze(pid_lat, state.pid_lat)
  pid_lon = freeze(pid_lon, state.pid_lon)

  if noise > 0.0:
    # Epsilon-noise: uniform sample from the action space.
    random_action = torch.stack([
        rng_lib.uniform(rng_action, (), 0.0, 1.0),
        rng_lib.uniform(rng_lib.fold_in(rng_action, 1), (), -1.0, 1.0),
        rng_lib.uniform(rng_lib.fold_in(rng_action, 2), (), 0.0, 1.0),
    ], dim=-1)
    take_random = rng_lib.uniform(rng_noise) < noise
    action = torch.where(take_random[:, None], random_action, action)

  return action, state.replace(pid_lat=pid_lat, pid_lon=pid_lon, rng=rng,
                               hero_wait=hero_wait.to(torch.int32))
