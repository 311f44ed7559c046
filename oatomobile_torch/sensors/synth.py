"""Observation synthesis over a scene batch.

Port of the JAX package's ``sensors/synth.py``: each sensor is a function
of ``(params, state)`` returning ``[B, ...]``.  The state sensors, the
goal sensor and the BEV LIDAR are ported; the cameras, the bird-view
renders and the game-state masks are not yet, and asking for them raises
``NotImplementedError``.

The LIDAR goes through the hand-written CUDA splat when the state lies on
a card (``ops/bev_cuda.py``); on the CPU the same wrapper runs its plain
version.
"""

from typing import Dict, Sequence

import torch

from oatomobile_torch.ops import bev, bev_cuda
from oatomobile_torch.sim import traffic
from oatomobile_torch.sim.types import SceneState, WorldParams
from oatomobile_torch.sim.util import take

# Observation keys synthesised on device (order-independent).
STATE_SENSORS = (
    "control",
    "location",
    "rotation",
    "velocity",
    "acceleration",
    "orientation",
    "angular_velocity",
    "speed_limit",
    "is_at_traffic_light",
    "traffic_light_state",
    "collision",
    "lane_invasion",
    "goal",
)

NUM_GOALS = 10          # reference defaults.py:139 num_goals
GOAL_SPACING_M = 2.0    # reference defaults.py:140 sampling_radius

# Sensors of the JAX package that this port does not synthesise yet.
NOT_PORTED = ("bird_view_camera_rgb", "bird_view_camera_cityscapes",
              "game_state", "front_camera_rgb", "rear_camera_rgb",
              "left_camera_rgb", "right_camera_rgb")


def _with_zero(xy: torch.Tensor) -> torch.Tensor:
  return torch.cat([xy, torch.zeros_like(xy[..., :1])], dim=-1)


def location(state: SceneState) -> torch.Tensor:
  """[B, 3] world location (z = 0 plane)."""
  return _with_zero(state.hero_xy)


def rotation(state: SceneState) -> torch.Tensor:
  """[B, 3] (pitch, yaw, roll) in degrees."""
  zero = torch.zeros_like(state.hero_yaw)
  return torch.stack([zero, torch.rad2deg(state.hero_yaw), zero], dim=-1)


def velocity(state: SceneState) -> torch.Tensor:
  """[B, 3] world-frame velocity m/s."""
  return _with_zero(state.hero_vel)


def acceleration(state: SceneState) -> torch.Tensor:
  """[B, 3] world-frame acceleration m/s^2."""
  return _with_zero(state.hero_accel)


def orientation(state: SceneState) -> torch.Tensor:
  """[B, 3] forward unit vector."""
  return torch.stack([torch.cos(state.hero_yaw), torch.sin(state.hero_yaw),
                      torch.zeros_like(state.hero_yaw)], dim=-1)


def angular_velocity(state: SceneState) -> torch.Tensor:
  """[B, 3] angular velocity, deg/s about z (CARLA convention)."""
  zero = torch.zeros_like(state.hero_yaw_rate)
  return torch.stack([zero, zero, torch.rad2deg(state.hero_yaw_rate)],
                     dim=-1)


def speed_limit(params: WorldParams, state: SceneState) -> torch.Tensor:
  """[B] speed limit in km/h."""
  return params.map["wp_speed_limit"][state.hero_wp.long()] * 3.6


def traffic_light_observables(params: WorldParams, state: SceneState):
  """(is_at_traffic_light [B], traffic_light_state [B]) int32, codes as
  carla.TrafficLightState."""
  tl_states = traffic.traffic_light_states(params, state.time)
  governed, tl_state = traffic.light_for_waypoint(params, state.hero_wp,
                                                  tl_states)
  return governed.to(torch.int32), tl_state.to(torch.int32)


def goal(params: WorldParams, state: SceneState) -> torch.Tensor:
  """[B, NUM_GOALS, 3] next route waypoints in the ego frame."""
  offsets = torch.arange(NUM_GOALS, device=state.route.device)
  idx = torch.minimum(torch.clamp_min(state.route_pos[:, None] + offsets, 0),
                      (state.route_len - 1)[:, None])
  pts = params.map["wp_xy"][take(state.route, idx).long()]
  rel = pts - state.hero_xy[:, None, :]
  cos_y = torch.cos(state.hero_yaw)[:, None]
  sin_y = torch.sin(state.hero_yaw)[:, None]
  x = cos_y * rel[..., 0] + sin_y * rel[..., 1]
  y = -sin_y * rel[..., 0] + cos_y * rel[..., 1]
  return torch.stack([x, y, torch.zeros_like(x)], dim=-1)


def lidar(params: WorldParams, state: SceneState) -> torch.Tensor:
  """[B, 200, 200, 2] BEV LIDAR splat: nearest-k selection in PyTorch,
  then the splat kernel (its plain version for CPU tensors)."""
  return bev_cuda.splat_lidar_batch(*bev.gather_inputs(params, state))


def actors_tracker(state: SceneState) -> torch.Tensor:
  """[B, K+P, 4] (x, y, z, alive) poses of all non-hero actors."""
  rows = []
  for xy, alive in ((state.npc_xy, state.npc_alive),
                    (state.ped_xy, state.ped_alive)):
    if xy.shape[1] > 0:
      rows.append(torch.cat([_with_zero(xy),
                             alive[..., None].to(torch.float32)], dim=-1))
  if not rows:
    return torch.zeros((state.batch_size, 0, 4), dtype=torch.float32,
                       device=state.hero_xy.device)
  return torch.cat(rows, dim=1)


def synthesize(params: WorldParams,
               state: SceneState,
               keys: Sequence[str] = STATE_SENSORS) -> Dict[str,
                                                            torch.Tensor]:
  """Synthesises the observation dict (each value [B, ...]) for the
  requested sensor keys."""
  out: Dict[str, torch.Tensor] = {}
  for key in keys:
    if key == "control":
      out[key] = state.hero_control
    elif key == "location":
      out[key] = location(state)
    elif key == "rotation":
      out[key] = rotation(state)
    elif key == "velocity":
      out[key] = velocity(state)
    elif key == "acceleration":
      out[key] = acceleration(state)
    elif key == "orientation":
      out[key] = orientation(state)
    elif key == "angular_velocity":
      out[key] = angular_velocity(state)
    elif key == "speed_limit":
      out[key] = speed_limit(params, state)
    elif key == "is_at_traffic_light":
      out[key] = traffic_light_observables(params, state)[0]
    elif key == "traffic_light_state":
      out[key] = traffic_light_observables(params, state)[1]
    elif key == "collision":
      out[key] = state.collision
    elif key == "lane_invasion":
      out[key] = state.lane_invasion
    elif key == "red_light_invasion":
      out[key] = state.red_light_invasion
    elif key == "goal":
      out[key] = goal(params, state)
    elif key == "lidar":
      out[key] = lidar(params, state)
    elif key == "actors_tracker":
      out[key] = actors_tracker(state)
    elif key in NOT_PORTED:
      raise NotImplementedError(
          "sensor {!r} is not ported to oatomobile_torch yet".format(key))
    else:
      raise KeyError("Unknown on-device sensor {!r}".format(key))
  return out
