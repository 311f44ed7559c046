"""Traffic: signal phases, background-vehicle policy, pedestrians.

Port of the JAX package's ``sim/traffic.py`` over a scene batch: every
NPC follows the lane-waypoint graph with pure-pursuit steering,
proportional speed control, path-aware car-following and red-light
compliance, as gathers + elementwise math over ``[B, K]`` (and the
``[B, K, L, K+1]`` all-pairs path test).  The reasons behind each rule
(and the measurements that chose its constants) are in the JAX module's
comments; this module ports what that code does.
"""

import math
from typing import Tuple

import torch

from oatomobile_torch import rng as rng_lib
from oatomobile_torch.sim import dynamics
from oatomobile_torch.sim.types import SceneState, WorldParams
from oatomobile_torch.sim.util import hypot, norm, take, wrap_angle

# CARLA TrafficLightState integer codes.
TL_RED, TL_YELLOW_STATE, TL_GREEN, TL_OFF, TL_UNKNOWN = 0, 1, 2, 3, 4

# Upcoming lane waypoints (~2 m apart) each NPC checks for path blockers.
PATH_LOOKAHEAD = 6


def traffic_light_states(params: WorldParams,
                         time: torch.Tensor) -> torch.Tensor:
  """CARLA-coded state of every light at each scene's ``time`` [B]:
  [B, L] int32.  Two phase groups alternate; per-junction offsets stagger
  the cycles."""
  g, y = params.tl_green, params.tl_yellow
  half = g + y
  cycle = 2.0 * half
  tl_offset = params.map["tl_offset"]
  tl_group = params.map["tl_group"]
  phase = torch.remainder(
      time[:, None] + tl_offset[None, :] +
      tl_group.to(torch.float32)[None, :] * half, cycle)
  out = torch.where(phase < g, TL_GREEN,
                    torch.where(phase < half, TL_YELLOW_STATE, TL_RED))
  return out.to(torch.int32)


def light_for_waypoint(params: WorldParams, wp: torch.Tensor,
                       tl_states: torch.Tensor) -> Tuple[torch.Tensor,
                                                         torch.Tensor]:
  """(is_governed, state) for the light governing each waypoint ``wp``
  ([B, ...]); state is TL_UNKNOWN where no light governs it."""
  tl_id = params.map["wp_tl"][wp.long()]
  governed = tl_id >= 0
  num_lights = tl_states.shape[-1]
  if num_lights == 0:
    return torch.zeros_like(governed), torch.full_like(tl_id, TL_UNKNOWN)
  state = take(tl_states, torch.clamp(tl_id, 0, num_lights - 1))
  return governed, torch.where(governed, state, TL_UNKNOWN).to(torch.int32)


def _advance_waypoint(params: WorldParams, xy: torch.Tensor,
                      wp: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
  """Advances each NPC's target waypoint once it is reached; ``u`` in
  [0,1) picks among junction successors (random turn choice)."""
  wp_l = wp.long()
  wp_xy = params.map["wp_xy"][wp_l]
  reached = norm(wp_xy - xy) < 3.0
  num_next = params.map["wp_num_next"][wp_l]
  pick = torch.minimum((u * num_next.to(torch.float32)).to(torch.int32),
                       num_next - 1)
  successors = params.map["wp_next"][wp_l]               # [B, K, MAX_NEXT]
  nxt = torch.gather(successors, -1, pick[..., None].long())[..., 0]
  # NPC-restricted roads: re-pick the next branch up to twice; if every
  # branch is restricted, proceed anyway (never strand a vehicle).
  for bump in (1, 2):
    alt_idx = torch.remainder(pick + bump, torch.clamp_min(num_next, 1))
    alt = torch.gather(successors, -1, alt_idx[..., None].long())[..., 0]
    nxt = torch.where(params.map["wp_npc_ok"][nxt.long()], nxt, alt)
  return torch.where(reached, nxt, wp)


def _slot_stride(K: int, device) -> torch.Tensor:
  """[K] golden-ratio stride in [0, 1): per-slot heterogeneity."""
  return torch.remainder(
      torch.arange(K, dtype=torch.float32, device=device) * 0.618034, 1.0)


def npc_step(params: WorldParams, state: SceneState,
             tl_states: torch.Tensor, rng: torch.Tensor) -> SceneState:
  """Advances all background vehicles of every scene one tick."""
  K = state.num_npcs
  if K == 0:
    return state
  B = state.batch_size
  device = state.npc_xy.device
  xy, yaw, speed = state.npc_xy, state.npc_yaw, state.npc_speed
  alive = state.npc_alive
  vehicle = params.vehicle

  # 1. Waypoint target management (random turns at junctions).
  u = rng_lib.uniform(rng, (K,))
  wp = _advance_waypoint(params, xy, state.npc_wp, u)
  wp_l = wp.long()
  target = params.map["wp_xy"][wp_l]

  # 2. Pure-pursuit steering towards the target waypoint.
  to_t = target - xy
  desired = torch.atan2(to_t[..., 1], to_t[..., 0])
  err = wrap_angle(desired - yaw)
  steer = torch.clamp(1.5 * err, -1.0, 1.0)

  # 3. Speed: limit, curvature slowdown, car-following, red lights, hero.
  stride = _slot_stride(K, device)
  factor = 0.75 + 0.5 * stride
  target_speed = torch.minimum(params.npc_target_speed * factor,
                               params.map["wp_speed_limit"][wp_l])
  bend = params.map["wp_bend"][wp_l]
  target_speed = target_speed * torch.clamp(
      1.0 - torch.maximum(err.abs(), 0.7 * bend), 0.3, 1.0)

  # Car-following + intercept prediction, all pairs in the NPC frame:
  # column j < K is NPC j, column K is the hero.
  other_xy = torch.cat([xy, state.hero_xy[:, None]], dim=1)   # [B, K+1, 2]
  heading = torch.stack([torch.cos(yaw), torch.sin(yaw)], dim=-1)
  other_vel = torch.cat([speed[..., None] * heading,
                         state.hero_vel[:, None]], dim=1)
  self_vel = speed[..., None] * heading
  rel = other_xy[:, None, :, :] - xy[:, :, None, :]          # [B, K, K+1, 2]
  rel_vel = other_vel[:, None, :, :] - self_vel[:, :, None, :]
  cos_y, sin_y = torch.cos(yaw), torch.sin(yaw)
  other_alive = torch.cat(
      [alive, torch.ones((B, 1), dtype=torch.bool, device=device)], dim=1)
  not_self = ~torch.eye(K, K + 1, dtype=torch.bool, device=device)

  def fwd_lat(r):
    fwd = cos_y[..., None] * r[..., 0] + sin_y[..., None] * r[..., 1]
    lat = -sin_y[..., None] * r[..., 0] + cos_y[..., None] * r[..., 1]
    return fwd, lat

  other_yaw = torch.cat([yaw, state.hero_yaw[:, None]], dim=1)
  other_speed = torch.cat([speed, state.hero_speed[:, None]], dim=1)
  moving_j = (other_speed > 0.5)[:, None, :]                  # [B, 1, K+1]
  cos_rel = torch.cos(other_yaw[:, None, :] - yaw[:, :, None])
  rel_fut = rel + rel_vel * 1.0
  fwd_now, lat_now = fwd_lat(rel)
  fwd_fut, lat_fut = fwd_lat(rel_fut)

  # Path-aware blocking against each NPC's upcoming lane points.
  dist_all = norm(rel)                                        # [B, K, K+1]
  p_xy = params.map["wp_path_xy"][wp_l]                       # [B, K, L, 2]
  d = norm(other_xy[:, None, None, :, :] -
           p_xy[:, :, :, None, :])                            # [B, K, L, K+1]
  on_path_l = d < 2.2
  on_my_path = torch.any(on_path_l, dim=2)                    # [B, K, K+1]
  # Hero column, exact: distance from the path to the hero's rectangle.
  rel_h = p_xy - state.hero_xy[:, None, None, :]              # [B, K, L, 2]
  ch = torch.cos(state.hero_yaw)[:, None, None]
  sh = torch.sin(state.hero_yaw)[:, None, None]
  hx = ch * rel_h[..., 0] + sh * rel_h[..., 1]
  hy = -sh * rel_h[..., 0] + ch * rel_h[..., 1]
  dxh = torch.clamp_min(hx.abs() - vehicle.length / 2.0, 0.0)
  dyh = torch.clamp_min(hy.abs() - vehicle.width / 2.0, 0.0)
  hero_on_path = torch.any(hypot(dxh, dyh) < 1.6, dim=2)      # [B, K]
  on_my_path = torch.cat(
      [on_my_path[..., :K], on_my_path[..., K:] | hero_on_path[..., None]],
      dim=-1)
  on_my_path = on_my_path & (fwd_now > -1.0)                  # not behind me

  # Right of way: the hero first, then lower slot index.
  j_idx = torch.arange(K + 1, device=device)[None, :]
  k_idx = torch.arange(K, device=device)[:, None]
  has_priority = (j_idx == K) | (j_idx < k_idx)               # [K, K+1]
  blocked_now = on_my_path & (moving_j | has_priority | (dist_all < 6.0))
  head_on_close = ((cos_rel < -0.5) & (fwd_now > 0.0) & (fwd_now < 7.0) &
                   (lat_now.abs() < 2.6) & other_alive[:, None, :] &
                   not_self)

  same_dir = cos_rel > 0.5
  oncoming_passer = ((cos_rel < -0.5) & moving_j &
                     (lat_now.abs() > 1.2) & (lat_fut.abs() > 1.0))
  fwd_gap = fwd_fut - speed[..., None] * 1.0
  intercept = ((fwd_gap > -2.0) & (fwd_gap < 5.5) &
               (lat_fut.abs() < 2.0 + 0.15 * torch.clamp_min(fwd_fut, 0.0)) &
               moving_j)
  blocked_fut = intercept & ~oncoming_passer & (same_dir | has_priority)
  valid = other_alive[:, None, :] & not_self
  cross_mover = on_my_path & moving_j & ~same_dir & valid
  follow_target = (blocked_now & ~moving_j & valid) | \
      (on_my_path & moving_j & same_dir & valid)
  d_masked = torch.where(follow_target, dist_all, 1e9)        # [B, K, K+1]
  d_q = torch.amin(d_masked, dim=-1)
  v_leader = torch.where(d_q < 1e8,
                         take(other_speed, torch.argmin(d_masked, dim=-1)),
                         0.0)
  closing = speed > v_leader - 0.3
  queue_stop = (speed * speed > 2.0 * 2.0 * torch.clamp_min(d_q - 6.0, 0.0)) \
      | ((d_q < 6.0) & closing)
  mover_hard = torch.any(cross_mover | (blocked_fut & valid), dim=-1)
  any_on_path = torch.any(on_path_l, dim=2)
  first_l = torch.argmax(on_path_l.to(torch.int32), dim=2)   # [B, K, K+1]
  d_conf = torch.where(any_on_path,
                       2.0 * (first_l.to(torch.float32) + 1.0), 1e9)
  d_cross = torch.where(cross_mover, torch.minimum(d_conf, dist_all), 1e9)
  d_hazard = torch.amin(d_cross, dim=-1)                      # [B, K]
  graded_hard = (speed * speed >
                 2.0 * 2.5 * torch.clamp_min(d_hazard - 4.5, 0.0)) | \
      (d_hazard < 4.5)
  # Don't block the box.
  at_junction = params.map["wp_is_junction"][wp_l]
  box_ahead = torch.any(params.map["wp_path_junction"][wp_l], dim=-1)
  stopped_on_path = torch.any(on_my_path & ~moving_j & valid, dim=-1)
  box_hold = ~at_junction & box_ahead & stopped_on_path

  governed, tl_state = light_for_waypoint(params, wp, tl_states)
  red = governed & (tl_state != TL_GREEN)

  # Patience-based yield assertion, thresholds staggered per slot.
  static_stop = queue_stop | box_hold
  patience = (120.0 + 60.0 * stride).to(torch.int32)
  asserting = state.npc_wait > patience
  effective_hard = torch.where(asserting, graded_hard, mover_hard)
  blocked = effective_hard | static_stop
  # Leaky patience: accumulate while mover-held, pause at reds/queues,
  # decay 5x when moving.
  held = mover_hard & (speed < 1.5) & ~static_stop & ~red
  pause = (static_stop | red) & (speed < 1.5)
  npc_wait = torch.where(
      (asserting & mover_hard) | held,
      torch.clamp_max(state.npc_wait + 1, 100000),
      torch.where(pause, state.npc_wait,
                  torch.clamp_min(state.npc_wait - 5, 0)))

  conflict = torch.any(head_on_close, dim=-1)
  evade = -torch.sign(torch.sum(
      torch.where(head_on_close, torch.sign(lat_now), 0.0), dim=-1))
  steer = torch.clamp(steer + torch.where(conflict, 0.6 * evade, 0.0), -1.0,
                      1.0)
  target_speed = torch.where(
      blocked | red, 0.0,
      torch.where(conflict | (asserting & mover_hard),
                  torch.clamp_max(target_speed, 1.5), target_speed))

  # 4. Proportional accel -> pseudo throttle/brake -> bicycle step.
  accel_cmd = torch.clamp(1.2 * (target_speed - speed), -vehicle.max_brake,
                          vehicle.max_accel)
  throttle = torch.clamp(accel_cmd / vehicle.max_accel, 0.0, 1.0)
  brake = torch.clamp(-accel_cmd / vehicle.max_brake, 0.0, 1.0)
  new_xy, new_yaw, new_speed = dynamics.bicycle_step(
      xy, yaw, speed, throttle, steer, brake, vehicle, params.dt)

  # Tow-away of NPCs stalled inside junctions (and, at twice the
  # threshold, anywhere unless the hero's body blocks them).  The stall
  # integrator's code decays 5x under a non-green light ahead, as the
  # JAX package's code does (its comment says the integrator pauses).
  num_lights = tl_states.shape[-1]
  tl_ahead = params.map["wp_tl_ahead"][wp_l]
  if num_lights:
    red_ahead = (tl_ahead >= 0) & (
        take(tl_states, torch.clamp(tl_ahead, 0, num_lights - 1)) != TL_GREEN)
  else:
    red_ahead = torch.zeros((B, K), dtype=torch.bool, device=device)
  stalled = alive & (speed < 0.5) & ~red & ~red_ahead
  npc_stall = torch.where(stalled, state.npc_stall + 1,
                          torch.clamp_min(state.npc_stall - 5, 0))
  tow_after = (300.0 + 100.0 * stride).to(torch.int32)
  hero_blocking = on_my_path[..., K]
  towed = (at_junction & (npc_stall > tow_after)) | \
      (~hero_blocking & (npc_stall > 2 * tow_after))
  alive = alive & ~towed

  # Dead NPCs stay frozen.
  new_xy = torch.where(alive[..., None], new_xy, xy)
  new_yaw = torch.where(alive, new_yaw, yaw)
  new_speed = torch.where(alive, new_speed, 0.0)
  return state.replace(npc_xy=new_xy, npc_yaw=new_yaw, npc_speed=new_speed,
                       npc_wp=wp, npc_wait=npc_wait.to(torch.int32),
                       npc_stall=npc_stall.to(torch.int32), npc_alive=alive)


def pedestrian_step(params: WorldParams, state: SceneState,
                    rng: torch.Tensor) -> SceneState:
  """Random-walk pedestrians constrained near the sidewalk band."""
  P = state.num_pedestrians
  if P == 0:
    return state
  speed = 1.4  # m/s walking speed
  turn = rng_lib.normal(rng, (P,)) * 0.3
  new_yaw = state.ped_yaw + turn
  heading = torch.stack([torch.cos(new_yaw), torch.sin(new_yaw)], dim=-1)
  cand = state.ped_xy + params.dt * speed * heading
  # Reject moves into buildings: sample the obstacle raster and bounce.
  origin = params.map["raster_origin"]
  ppm = params.map["raster_ppm"]
  H, W = params.map["obstacle_mask"].shape
  idx = torch.round((cand - origin) * ppm).to(torch.int32)
  ix = torch.clamp(idx[..., 0], 0, H - 1).long()
  iy = torch.clamp(idx[..., 1], 0, W - 1).long()
  hit = params.map["obstacle_mask"][ix, iy]
  new_xy = torch.where(hit[..., None], state.ped_xy, cand)
  new_yaw = torch.where(hit, new_yaw + math.pi, new_yaw)
  alive = state.ped_alive
  new_xy = torch.where(alive[..., None], new_xy, state.ped_xy)
  return state.replace(ped_xy=new_xy, ped_yaw=new_yaw)
