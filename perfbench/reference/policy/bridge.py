"""Plan -> control bridge of the learned in-loop policies: port of the JAX
package's ``baselines/learned/bridge.py``.

The [B, T, 2] ego-frame plan (1 s spacing) is tracked through an
interpolated setpoint; the target speed comes from the setpoint spacing,
scaled down by the plan's own bend; lateral and longitudinal PIDs give
the control.  A warm-up floor, a stall kick along the route and a
standstill steering clamp, each gated by the agent's own BEV, are the JAX
package's (its docstrings give the measurements behind each).  The PIDs
are already batched here, so nothing is vmapped.
"""

from typing import Optional, Tuple

import numpy as np
import torch

from perfbench.reference.sim import dynamics
from perfbench.reference.sim.types import SceneState, WorldParams
from perfbench.reference.sim.util import constant, norm

_PLAN_DT = 1.0  # seconds between downsampled plan points
_PPM = 200 / 101.0  # BEV pixels per metre (1 / BIN_WIDTH)


def _linspace(start: float, stop: float, num: int) -> tuple:
  """``jnp.linspace(start, stop, num)`` as float32 values (XLA's rounding
  of it may differ in the last ulp)."""
  return tuple(np.linspace(start, stop, num, dtype=np.float32).tolist())


def bev_clear_ahead(lidar: torch.Tensor,
                    *,
                    reach_m: float = 8.0,
                    half_width_m: float = 1.3,
                    threshold: float = 0.15) -> torch.Tensor:
  """[B] bool: no above-ground return (channel 1) in the forward corridor
  of the agent's own [B, 200, 200, 2] BEV, from past the hero's nose
  (2.5 m) to ``reach_m``."""
  r0 = int(round((2.5 + 50.0) * _PPM))
  r1 = int(round((reach_m + 50.0) * _PPM))
  c0 = int(round((-half_width_m + 50.0) * _PPM))
  c1 = int(round((half_width_m + 50.0) * _PPM)) + 1
  window = lidar[:, r0:r1, c0:c1, 1]
  return window.amax(dim=(1, 2)) <= threshold


def bev_clear_toward(lidar: torch.Tensor,
                     toward_xy: torch.Tensor,
                     *,
                     reach_m: float = 8.0,
                     half_width_m: float = 1.1,
                     threshold: float = 0.15,
                     num_samples: int = 16) -> torch.Tensor:
  """[B] bool: the pixel corridor along the ray to the ego-frame point
  ``toward_xy`` [B, 2] holds no above-ground return: ``num_samples``
  points from 2.5 m to ``reach_m``, at three lateral offsets each."""
  B = lidar.shape[0]
  theta = torch.atan2(toward_xy[:, 1], toward_xy[:, 0])          # [B]
  u = torch.stack([torch.cos(theta), torch.sin(theta)], -1)      # [B, 2]
  n = torch.stack([-u[:, 1], u[:, 0]], -1)                       # [B, 2]
  d = constant(_linspace(2.5, reach_m, num_samples), lidar.device)  # [S]
  w = constant((-half_width_m, 0.0, half_width_m), lidar.device)    # [3]
  # [B, S, 3, 2] ego-frame sample points.
  pts = (d[None, :, None, None] * u[:, None, None, :] +
         w[None, None, :, None] * n[:, None, None, :])
  rows = torch.clamp(torch.round((pts[..., 0] + 50.0) * _PPM), 0, 199)
  cols = torch.clamp(torch.round((pts[..., 1] + 50.0) * _PPM), 0, 199)
  flat = (rows * 200 + cols).to(torch.int64).reshape(B, -1)
  above = lidar[..., 1].reshape(B, -1)                           # [B, H*W]
  return torch.gather(above, 1, flat).amax(dim=-1) <= threshold


def plan_to_action(
    world_params: WorldParams,
    states: SceneState,
    plan: torch.Tensor,
    *,
    setpoint_frac: float = 0.5,
    use_brake: bool = True,
    curvature_slowdown: bool = True,
    warmup_floor: float = 20.0 / 3.6,
    goal: Optional[torch.Tensor] = None,
    speed_gain: float = 1.0,
    stall_recovery: bool = True,
    red_held: Optional[torch.Tensor] = None,
    clear_ahead: Optional[torch.Tensor] = None,
    bev: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, SceneState]:
  """Converts an ego-frame plan batch [B, T, 2] into actions [B, 3]
  (throttle, steer, brake) and the states with updated PID controllers
  and stall counter.

  Args:
    goal: optional [B, G, 2] ego-frame route waypoints; when given, a
      degenerate plan (endpoint closer than 2 m) and the stall kick steer
      toward the first waypoint >= 4 m ahead.
    speed_gain: multiplier on the plan-derived target speed.
    red_held: [B] bool, held at a red or yellow light (no stall kick).
    clear_ahead: [B] bool corridor gate; replaced by probes of ``bev``
      [B, 200, 200, 2] when that is given.
  """
  B = plan.shape[0]
  setpoint_local = ((1.0 - setpoint_frac) * plan[:, 0] +
                    setpoint_frac * plan[:, 1])
  fallback = None
  if goal is not None:
    plan_reach = norm(plan[:, -1])                               # [B]
    dist = norm(goal)                                            # [B, G]
    ahead = (dist >= 4.0).to(torch.int32)
    # First waypoint >= 4 m out; the farthest one when none qualifies
    # (argmax returns the first maximum, as jnp.argmax does).
    idx = torch.where(ahead.any(dim=-1), torch.argmax(ahead, dim=-1),
                      torch.argmax(dist, dim=-1))                # [B]
    fallback = goal[torch.arange(B, device=goal.device), idx]    # [B, 2]
    setpoint_local = torch.where((plan_reach < 2.0)[:, None], fallback,
                                 setpoint_local)

  target_speed = speed_gain * norm(plan[:, 1] - plan[:, 0]) / _PLAN_DT

  slow = torch.ones(B, dtype=plan.dtype, device=plan.device)
  if curvature_slowdown:
    # Bend of the plan: the largest heading change between consecutive
    # segments, or the first segment's heading if larger.
    seg = plan[:, 1:] - plan[:, :-1]                             # [B, T-1, 2]
    seg_yaw = torch.atan2(seg[..., 1], seg[..., 0])
    first = torch.abs(torch.atan2(torch.sin(seg_yaw[:, 0]),
                                  torch.cos(seg_yaw[:, 0])))
    dyaw = seg_yaw[:, 1:] - seg_yaw[:, :-1]
    bend = torch.abs(torch.atan2(torch.sin(dyaw),
                                 torch.cos(dyaw))).amax(dim=-1)
    bend = torch.maximum(bend, first)
    slow = torch.clamp(1.0 - 0.8 * bend, 0.3, 1.0)
    target_speed = target_speed * slow

  limit = world_params.map["wp_speed_limit"][states.hero_wp.long()]
  target_speed = torch.minimum(target_speed, limit)

  # Stall-kick phase, up front: the kick redirects the setpoint as well as
  # the speed floor.
  phase_now = torch.remainder(states.hero_wait, 120)
  phase_kick = (phase_now > 20) & (phase_now <= 100)
  kick_target = setpoint_local
  if stall_recovery and fallback is not None:
    kick_target = torch.where(phase_kick[:, None], fallback, setpoint_local)

  # Direction-aware corridor along the ray the floor or kick would steer;
  # ``clear_short`` is the same probe cut to 4 m for the escalated creep.
  clear_short = None
  if bev is not None:
    clear_ahead = bev_clear_toward(bev, kick_target)
    clear_short = bev_clear_toward(bev, kick_target, reach_m=4.0,
                                   num_samples=8)
  # Spawn warm-up floor, scaled by the plan-curvature factor.
  if warmup_floor > 0.0:
    floor_ok = (torch.ones(B, dtype=torch.bool, device=plan.device)
                if clear_ahead is None else clear_ahead)
    target_speed = torch.where((states.step <= 100) & floor_ok,
                               torch.maximum(target_speed,
                                             warmup_floor * slow),
                               target_speed)

  # Mid-episode stall recovery: 1 s stopped arms a 4 s floor of 2.5 m/s
  # steered along the route, then 1 s of model control; never at a red,
  # never into an occupied corridor; after 12 s armed, a 1.5 m/s creep
  # under the 4 m probe.
  new_wait = states.hero_wait
  kick = None
  if stall_recovery:
    slow_now = states.hero_speed < 1.0
    blocked_red = (red_held if red_held is not None else
                   torch.zeros(B, dtype=torch.bool, device=plan.device))
    new_wait = torch.where(
        (slow_now | phase_kick) & ~blocked_red & (states.step > 100),
        states.hero_wait + 1, torch.zeros_like(states.hero_wait))
    phase = torch.remainder(new_wait, 120)
    kick = (phase > 20) & (phase <= 100)
    kick_speed = torch.full((B,), 2.5, dtype=plan.dtype, device=plan.device)
    if clear_ahead is not None:
      wedged = new_wait > 240
      short = clear_short if clear_short is not None else clear_ahead
      gate = torch.where(wedged, short, clear_ahead)
      kick_speed = torch.where(wedged, 1.5, kick_speed)
      kick = kick & gate
    target_speed = torch.where(kick, torch.maximum(target_speed, kick_speed),
                               target_speed)
    setpoint_local = torch.where(kick[:, None], kick_target, setpoint_local)

  # Ego -> world.
  cos_y = torch.cos(states.hero_yaw)
  sin_y = torch.sin(states.hero_yaw)
  target_xy = torch.stack([
      states.hero_xy[:, 0] + cos_y * setpoint_local[:, 0] -
      sin_y * setpoint_local[:, 1],
      states.hero_xy[:, 1] + sin_y * setpoint_local[:, 0] +
      cos_y * setpoint_local[:, 1],
  ], dim=-1)

  steer, pid_lat = dynamics.lateral_control(states.pid_lat, states.hero_xy,
                                            states.hero_yaw, target_xy,
                                            world_params.dt)
  # Standstill steering clamp: below 0.5 m/s and outside a kick window,
  # steering is held to +-0.25.
  if stall_recovery:
    clamped = torch.clamp(steer, -0.25, 0.25)
    steer = torch.where(kick | (states.hero_speed >= 0.5), steer, clamped)
  if use_brake:
    throttle, brake, pid_lon = dynamics.longitudinal_control_with_brake(
        states.pid_lon, states.hero_speed, target_speed, world_params.dt,
        brake_deadband=1.0, brake_slope=0.25)
  else:
    throttle, pid_lon = dynamics.longitudinal_control(
        states.pid_lon, states.hero_speed, target_speed, world_params.dt)
    brake = torch.zeros_like(throttle)

  actions = torch.stack([throttle, steer, brake], dim=-1)
  return actions, states.replace(pid_lat=pid_lat, pid_lon=pid_lon,
                                 hero_wait=new_wait)
