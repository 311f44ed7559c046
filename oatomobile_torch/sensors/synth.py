"""Observation synthesis over a scene batch.

Port of the JAX package's ``sensors/synth.py``: each sensor is a function
of ``(params, state)`` returning ``[B, ...]``: the state sensors, the goal
sensor, the BEV LIDAR, the two bird-view renders, the four perspective
cameras (``sensors/cameras.py``) and the game-state masks.

The LIDAR goes through the hand-written CUDA splat when the state lies on
a card (``ops/bev_cuda.py``); on the CPU the same wrapper runs its plain
version.  The cameras and the masks are plain PyTorch, as they are XLA
code in the JAX package.
"""

from typing import Dict, Sequence

import numpy as np
import torch

from oatomobile_torch.ops import bev, bev_cuda
from oatomobile_torch.sensors import cameras
from oatomobile_torch.sim import traffic
from oatomobile_torch.sim.types import SceneState, WorldParams
from oatomobile_torch.sim.util import constant, take

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

# The perspective cameras: yaw offset from the hero's heading, degrees.
CAMERA_YAW_OFFSETS = {"front_camera_rgb": 0.0, "rear_camera_rgb": 180.0,
                      "left_camera_rgb": 270.0, "right_camera_rgb": 90.0}


def _with_zero(xy: torch.Tensor) -> torch.Tensor:
  return torch.cat([xy, torch.zeros_like(xy[..., :1])], dim=-1)


def hero_yaw_deg(state: SceneState) -> torch.Tensor:
  """[B] the hero's yaw in degrees."""
  return torch.rad2deg(state.hero_yaw)


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


# --- Bird-view cameras ------------------------------------------------------
# CityScapes palette entries used by CARLA semantic segmentation, and the
# RGB pseudo-render's colours (as float32 in [0, 1]).
_CS_ROAD = np.asarray([128, 64, 128], np.float32) / 255.0
_CS_ROADLINE = np.asarray([157, 234, 50], np.float32) / 255.0
_CS_BUILDING = np.asarray([70, 70, 70], np.float32) / 255.0
_CS_VEHICLE = np.asarray([0, 0, 142], np.float32) / 255.0
_CS_PEDESTRIAN = np.asarray([220, 20, 60], np.float32) / 255.0
_CS_GROUND = np.asarray([81, 0, 81], np.float32) / 255.0

_RGB_ROAD = np.asarray([60, 60, 60], np.float32) / 255.0
_RGB_LINE = np.asarray([200, 200, 200], np.float32) / 255.0
_RGB_BUILDING = np.asarray([120, 100, 90], np.float32) / 255.0
_RGB_VEHICLE = np.asarray([30, 60, 140], np.float32) / 255.0
_RGB_PED = np.asarray([200, 60, 60], np.float32) / 255.0
_RGB_GROUND = np.asarray([90, 120, 80], np.float32) / 255.0
_RGB_HERO = np.asarray([200, 30, 30], np.float32) / 255.0

# Palettes indexed by the class codes of `_bird_view_classes`.
_CS_PALETTE = tuple(map(tuple, np.stack([
    _CS_GROUND, _CS_ROAD, _CS_ROADLINE, _CS_BUILDING, _CS_VEHICLE,
    _CS_PEDESTRIAN, _CS_VEHICLE]).tolist()))
_RGB_PALETTE = tuple(map(tuple, np.stack([
    _RGB_GROUND, _RGB_ROAD, _RGB_LINE, _RGB_BUILDING, _RGB_VEHICLE,
    _RGB_PED, _RGB_HERO]).tolist()))

BIRD_VIEW_SIZE = 200      # 200x200, as the reference's z = 25 camera
BIRD_VIEW_METERS = 25.0   # half-width covered


def _bird_view_axis(device) -> torch.Tensor:
  """[BIRD_VIEW_SIZE] pixel centres along one axis, metres from the hero
  (``jnp.linspace`` of the JAX package, to its last ulp)."""
  size, half = BIRD_VIEW_SIZE, BIRD_VIEW_METERS
  return constant(tuple(np.linspace(-half + half / size, half - half / size,
                                    size, dtype=np.float32).tolist()),
                  device)


def _bird_view_classes(params: WorldParams,
                       state: SceneState) -> torch.Tensor:
  """[B, 200, 200] int32 class image around each hero (axis conventions
  as the lidar): 0 ground, 1 road, 2 roadline, 3 building, 4 vehicle,
  5 pedestrian, 6 hero.

  The actor test is a plain [B, 200, 200, K] box test in torch, as in the
  JAX package (not a kernel there either)."""
  c = _bird_view_axis(state.hero_xy.device)
  size = c.shape[0]
  lx = c[:, None].expand(size, size)
  ly = c[None, :].expand(size, size)
  cos_y = torch.cos(state.hero_yaw)
  sin_y = torch.sin(state.hero_yaw)
  c3, s3 = cos_y[:, None, None], sin_y[:, None, None]
  wx = state.hero_xy[:, 0, None, None] + c3 * lx - s3 * ly
  wy = state.hero_xy[:, 1, None, None] + s3 * lx + c3 * ly

  origin = params.map["raster_origin"]
  ppm = params.map["raster_ppm"]
  road_mask = params.map["road_mask"]
  H, W = road_mask.shape
  ix = torch.clamp(torch.round((wx - origin[0]) * ppm).to(torch.int32), 0,
                   H - 1).long()
  iy = torch.clamp(torch.round((wy - origin[1]) * ppm).to(torch.int32), 0,
                   W - 1).long()
  cls = torch.zeros(wx.shape, dtype=torch.int32, device=wx.device)
  cls = torch.where(road_mask[ix, iy], 1, cls)
  cls = torch.where(params.map["lane_mask"][ix, iy], 2, cls)
  cls = torch.where(params.map["obstacle_mask"][ix, iy], 3, cls)

  def boxes_cls(xy, yaw, alive, half_l, half_w, code, cls):
    rel = xy - state.hero_xy[:, None, :]                        # [B, K, 2]
    cy, sy = cos_y[:, None], sin_y[:, None]
    u = cy * rel[..., 0] + sy * rel[..., 1]
    v = -sy * rel[..., 0] + cy * rel[..., 1]
    du = lx[None, :, :, None] - u[:, None, None, :]            # [B, S, S, K]
    dv = ly[None, :, :, None] - v[:, None, None, :]
    yr = yaw - state.hero_yaw[:, None]
    cr, sr = torch.cos(yr)[:, None, None, :], torch.sin(yr)[:, None, None, :]
    bu = cr * du + sr * dv
    bv = -sr * du + cr * dv
    inside = ((bu.abs() <= half_l) & (bv.abs() <= half_w) &
              alive[:, None, None, :])
    return torch.where(inside.any(-1), code, cls)

  vehicle = params.vehicle
  if state.num_npcs > 0:
    cls = boxes_cls(state.npc_xy, state.npc_yaw, state.npc_alive,
                    vehicle.length / 2, vehicle.width / 2, 4, cls)
  if state.num_pedestrians > 0:
    half = constant(float(np.float32(cameras.PED_HALF_SIZE)), wx.device)
    cls = boxes_cls(state.ped_xy, state.ped_yaw, state.ped_alive, half,
                    half, 5, cls)

  # Hero box at the centre.
  hero_inside = ((lx.abs() <= vehicle.length / 2) &
                 (ly.abs() <= vehicle.width / 2))
  return torch.where(hero_inside[None], 6, cls)


def bird_view_cityscapes(params: WorldParams,
                         state: SceneState) -> torch.Tensor:
  """[B, 200, 200, 3] float RGB in the CityScapes palette (sensor
  'bird_view_camera_cityscapes')."""
  palette = constant(_CS_PALETTE, state.hero_xy.device)
  return palette[_bird_view_classes(params, state).long()]


def bird_view_rgb(params: WorldParams, state: SceneState) -> torch.Tensor:
  """[B, 200, 200, 3] float RGB pseudo-render ('bird_view_camera_rgb')."""
  palette = constant(_RGB_PALETTE, state.hero_xy.device)
  return palette[_bird_view_classes(params, state).long()]


GAME_STATE_SIZE = 320        # hero-centric window (64 m at 5 px/m)
GAME_STATE_PPM = 5.0         # the reference's GAME_STATE pixels_per_meter
TL_SPLAT_HALF = 1.0          # a light is a 2x2 m splat


def _game_state_axis(device) -> torch.Tensor:
  """[GAME_STATE_SIZE] pixel centres along one axis, metres from the hero
  (``jnp.linspace`` of the JAX package, to a few ulps)."""
  size = GAME_STATE_SIZE
  half = size / (2.0 * GAME_STATE_PPM)
  return constant(tuple(np.linspace(-half + half / size, half - half / size,
                                    size, dtype=np.float32).tolist()),
                  device)


def _boxes_mask(wx, wy, xy, yaw, alive, half_l, half_w) -> torch.Tensor:
  """[B, H, W] bool: world grid points (x [B or 1, H, 1] by row, y
  [B or 1, 1, W] by column) inside any of each scene's oriented boxes
  (centres xy [B, K, 2], yaw [B, K], alive [B, K]).  A loop over the K
  slots with a running ``any``: the JAX package tests [H, W, K] at once,
  which eager PyTorch would materialise."""
  cr, sr = torch.cos(yaw), torch.sin(yaw)
  B, H, W = xy.shape[0], wx.shape[-2], wy.shape[-1]
  mask = torch.zeros((B, H, W), dtype=torch.bool, device=xy.device)
  for k in range(xy.shape[1]):
    rel_u = wx - xy[:, k, 0, None, None]                         # [B, H, 1]
    rel_v = wy - xy[:, k, 1, None, None]                         # [B, 1, W]
    c, s = cr[:, k, None, None], sr[:, k, None, None]
    bu = c * rel_u + s * rel_v
    bv = -s * rel_u + c * rel_v
    mask |= ((bu.abs() <= half_l) & (bv.abs() <= half_w) &
             alive[:, k, None, None])
  return mask


def _light_masks(params: WorldParams, state: SceneState, wx,
                 wy) -> Sequence[torch.Tensor]:
  """(green, yellow, red) [B, H, W] bool: grid points within 1 m on both
  axes of a light in that phase.  The grid is axis-aligned, so a light's
  splat is a band of rows times a band of columns, and a phase's mask is
  the boolean product of [B, H, L] rows and [B, L, W] columns (exact: 0/1
  terms, at most L of them)."""
  tl_xy = params.map["tl_xy"]
  B, H, W = state.batch_size, wx.shape[-2], wy.shape[-1]
  if tl_xy.shape[0] == 0:
    zeros = torch.zeros((B, H, W), dtype=torch.bool, device=tl_xy.device)
    return zeros, zeros, zeros
  tl_states = traffic.traffic_light_states(params, state.time)   # [B, L]
  rows = ((wx[..., 0, None] - tl_xy[:, 0]).abs() <= TL_SPLAT_HALF)
  cols = ((wy[..., 0, :, None] - tl_xy[:, 1]).abs() <= TL_SPLAT_HALF)
  rows = rows.to(torch.float32).expand(B, H, -1)                 # [B, H, L]
  cols = cols.to(torch.float32).transpose(-1, -2)                # [., L, W]
  return tuple(
      torch.matmul(rows * (tl_states == code)[:, None, :], cols) > 0.0
      for code in (traffic.TL_GREEN, traffic.TL_YELLOW_STATE,
                   traffic.TL_RED))


def _masks(params: WorldParams, state: SceneState, wx, wy, road,
           lanes) -> torch.Tensor:
  """[B, H, W, 8] int32 game-state channels over the world grid (x [B or
  1, H, 1], y [B or 1, 1, W]) given its road and lane masks."""
  vehicle = params.vehicle
  B, H, W = state.batch_size, wx.shape[-2], wy.shape[-1]
  zeros = torch.zeros((B, H, W), dtype=torch.bool, device=wx.device)
  vehicles = pedestrians = zeros
  if state.num_npcs > 0:
    vehicles = _boxes_mask(wx, wy, state.npc_xy, state.npc_yaw,
                           state.npc_alive, vehicle.length / 2,
                           vehicle.width / 2)
  if state.num_pedestrians > 0:
    half = constant(float(np.float32(cameras.PED_HALF_SIZE)), wx.device)
    pedestrians = _boxes_mask(wx, wy, state.ped_xy, state.ped_yaw,
                              state.ped_alive, half, half)
  green, yellow, red = _light_masks(params, state, wx, wy)
  hero = _boxes_mask(wx, wy, state.hero_xy[:, None, :],
                     state.hero_yaw[:, None],
                     torch.ones_like(state.hero_yaw[:, None],
                                     dtype=torch.bool),
                     vehicle.length / 2, vehicle.width / 2)
  return torch.stack([road.expand(B, H, W), lanes.expand(B, H, W), vehicles,
                      pedestrians, green, yellow, red, hero],
                     dim=-1).to(torch.int32)


def game_state(params: WorldParams, state: SceneState) -> torch.Tensor:
  """[B, 320, 320, 8] binary masks: road, lane boundaries, vehicles,
  pedestrians, green/yellow/red lights, hero, over a 64 m window around
  each hero, axis-aligned to the world (the JAX package's deliberate
  deviation from the reference's whole-town raster, which
  ``full_town_game_state`` gives)."""
  c = _game_state_axis(state.hero_xy.device)
  wx = state.hero_xy[:, 0, None, None] + c[None, :, None]        # [B, S, 1]
  wy = state.hero_xy[:, 1, None, None] + c[None, None, :]        # [B, 1, S]

  origin = params.map["raster_origin"]
  ppm = params.map["raster_ppm"]
  road_mask = params.map["road_mask"]
  H, W = road_mask.shape
  ix = torch.clamp(torch.round((wx - origin[0]) * ppm).to(torch.int32), 0,
                   H - 1).long()
  iy = torch.clamp(torch.round((wy - origin[1]) * ppm).to(torch.int32), 0,
                   W - 1).long()
  return _masks(params, state, wx, wy, road_mask[ix, iy],
                params.map["lane_mask"][ix, iy])


def full_town_game_state(params: WorldParams,
                         state: SceneState) -> torch.Tensor:
  """[B, H, W, 8] binary masks (channels as ``game_state``) over the whole
  town raster grid (``params.map["road_mask"]``'s resolution, raster_ppm
  px/m), as the reference's GameStateSensor rasterises the whole town each
  step.  Synthesise on demand: a town raster is ~1-2k px a side."""
  road = params.map["road_mask"]
  H, W = road.shape
  origin = params.map["raster_origin"]
  ppm = params.map["raster_ppm"]
  wx = origin[0] + torch.arange(H, dtype=torch.float32,
                                device=road.device) / ppm
  wy = origin[1] + torch.arange(W, dtype=torch.float32,
                                device=road.device) / ppm
  return _masks(params, state, wx[None, :, None], wy[None, None, :], road,
                params.map["lane_mask"])


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
    elif key == "bird_view_camera_rgb":
      out[key] = bird_view_rgb(params, state)
    elif key == "bird_view_camera_cityscapes":
      out[key] = bird_view_cityscapes(params, state)
    elif key == "game_state":
      out[key] = game_state(params, state)
    elif key in CAMERA_YAW_OFFSETS:
      out[key] = cameras.camera_rgb(params, state, CAMERA_YAW_OFFSETS[key])
    else:
      raise KeyError("Unknown on-device sensor {!r}".format(key))
  return out
