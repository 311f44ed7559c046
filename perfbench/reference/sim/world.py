"""The world step over a scene batch.

Port of the JAX package's ``sim/world.py``:

    world_step(params, state, action) -> state'

advances B scenes by one tick with tensors whose leading axis is the
scene (the JAX package ``vmap``s a one-scene step instead).  ``rollout``
is a Python loop over time in place of ``lax.scan``.  Scene
initialisation stays host-side numpy, so the same seed gives the same
scenes and the same per-scene keys as the JAX package.
"""

from typing import Optional

import numpy as np
import torch

from perfbench.reference import threefry as rng_lib
from perfbench.reference.maps.assets import TownMap
from perfbench.reference.maps.routing import plan_route_batch
from perfbench.reference.sim import dynamics, events, traffic
from perfbench.reference.sim.types import (PIDState, SceneState, VehicleSpec,
                                        WorldParams)
from perfbench.reference.sim.util import norm, take

# Route progress search window: how many route points ahead are examined
# when updating progress each step.
ROUTE_WINDOW = 8
DEFAULT_ROUTE_CAPACITY = 2048
# The reference simulator's tick rate and background-traffic cruise speed.
SIMULATOR_FPS = 20
NPC_TARGET_SPEED = 30.0 / 3.6  # m/s


def make_params(town: TownMap,
                fps: int = SIMULATOR_FPS,
                npc_target_speed: float = NPC_TARGET_SPEED,
                device="cuda") -> WorldParams:
  """Builds world parameters for a town on ``device``: a tick of
  ``1 / fps`` seconds, background traffic cruising at
  ``npc_target_speed`` m/s."""
  device = torch.device(device)

  def f32(x):
    return torch.tensor(np.float32(x), dtype=torch.float32, device=device)

  return WorldParams(
      map=town.tensors(device),
      vehicle=VehicleSpec.make(device),
      dt=f32(1.0 / fps),
      npc_target_speed=f32(npc_target_speed),
      tl_green=f32(10.0),   # measured optimum, see the JAX package
      tl_yellow=f32(3.0),
      proximity_vehicle_threshold=f32(10.0),
      proximity_tlight_threshold=f32(5.0),
      wall_budget=int(town.wall_budget),
      road_budget=int(town.road_budget),
  )


def nearest_waypoint_ongraph(params: WorldParams,
                             xy: torch.Tensor) -> torch.Tensor:
  """O(1) localisation: nearest waypoint id via the precomputed raster."""
  origin = params.map["raster_origin"]
  ppm = params.map["raster_ppm"]
  grid = params.map["nearest_wp"]
  H, W = grid.shape
  idx = torch.round((xy - origin) * ppm).to(torch.int32)
  ix = torch.clamp(idx[..., 0], 0, H - 1).long()
  iy = torch.clamp(idx[..., 1], 0, W - 1).long()
  return grid[ix, iy]


def _advance_route(params: WorldParams, state: SceneState,
                   new_xy: torch.Tensor) -> torch.Tensor:
  """Monotonically advances route progress to the closest point within a
  fixed look-ahead window."""
  offsets = torch.arange(ROUTE_WINDOW, device=new_xy.device)
  last = (state.route_len - 1)[:, None]
  idx = torch.minimum(torch.clamp_min(state.route_pos[:, None] + offsets, 0),
                      last)
  pts = params.map["wp_xy"][take(state.route, idx).long()]   # [B, W, 2]
  d = norm(pts - new_xy[:, None, :])
  pos = state.route_pos + torch.argmin(d, dim=-1).to(torch.int32)
  return torch.minimum(torch.clamp_min(pos, 0), last[:, 0])


def world_step(params: WorldParams, state: SceneState,
               action: torch.Tensor) -> SceneState:
  """Advances every scene by one tick.

  Args:
    params: static world configuration.
    state: the scene batch.
    action: [B, 3] (throttle, steer, brake).
  """
  keys = rng_lib.split(state.rng, 3)
  rng, rng_npc, rng_ped = keys[:, 0], keys[:, 1], keys[:, 2]

  # --- Hero dynamics ----------------------------------------------------
  throttle, steer, brake = action[:, 0], action[:, 1], action[:, 2]
  new_xy, new_yaw, new_speed = dynamics.bicycle_step(
      state.hero_xy, state.hero_yaw, state.hero_speed, throttle, steer,
      brake, params.vehicle, params.dt)

  # Derived measurements (CARLA get_velocity/get_acceleration observables).
  new_vel = (new_xy - state.hero_xy) / params.dt
  new_accel = (new_vel - state.hero_vel) / params.dt
  new_yaw_rate = (new_yaw - state.hero_yaw) / params.dt

  # --- Traffic ------------------------------------------------------------
  tl_states = traffic.traffic_light_states(params, state.time)
  state_mid = traffic.npc_step(params, state, tl_states, rng_npc)
  state_mid = traffic.pedestrian_step(params, state_mid, rng_ped)

  # --- Localisation + route progress --------------------------------------
  new_wp = nearest_waypoint_ongraph(params, new_xy)
  new_route_pos = _advance_route(params, state_mid, new_xy)

  # --- Events ---------------------------------------------------------------
  impulse = events.detect_collision(params, state_mid, new_xy, new_yaw,
                                    new_speed)
  invasion, off_lane = events.detect_lane_invasion(params, state_mid, new_xy,
                                                   new_wp)

  # Red-light invasion: entering the junction straight off a red-governed
  # approach.
  governed, tl_code = traffic.light_for_waypoint(params, new_wp, tl_states)
  at_red = governed & (tl_code == traffic.TL_RED)
  in_junction = params.map["wp_is_junction"][new_wp.long()]
  ran_red = (state.at_red_prev & in_junction & ~governed).to(torch.int32)

  return state_mid.replace(
      hero_xy=new_xy,
      hero_yaw=new_yaw,
      hero_speed=new_speed,
      hero_vel=new_vel,
      hero_accel=new_accel,
      hero_yaw_rate=new_yaw_rate,
      hero_control=torch.stack([throttle, steer, brake], dim=-1),
      hero_wp=new_wp,
      route_pos=new_route_pos,
      time=state.time + params.dt,
      step=state.step + 1,
      collision=impulse,
      lane_invasion=invasion,
      off_lane_prev=off_lane,
      red_light_invasion=ran_red,
      at_red_prev=at_red,
      rng=rng,
  )


# ---------------------------------------------------------------------------
# Scene initialisation (host side, numpy; one-time per episode)
# ---------------------------------------------------------------------------


def _state_from_host(arrays: dict, keys: torch.Tensor, B: int,
                     device) -> SceneState:
  """SceneState on ``device`` from the host-side numpy draws."""

  def t(x, dtype):
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

  f32, i32 = torch.float32, torch.int32
  K = arrays["npc_xy"].shape[1]
  P = arrays["ped_xy"].shape[1]

  def zeros(shape, dtype=f32):
    return torch.zeros(shape, dtype=dtype, device=device)

  return SceneState(
      hero_xy=t(arrays["hero_xy"], f32),
      hero_yaw=t(arrays["hero_yaw"], f32),
      hero_speed=zeros((B,)),
      hero_vel=zeros((B, 2)),
      hero_accel=zeros((B, 2)),
      hero_yaw_rate=zeros((B,)),
      hero_control=zeros((B, 3)),
      hero_wp=t(arrays["hero_wp"], i32),
      route=t(arrays["route"], i32),
      route_len=t(arrays["route_len"], i32),
      route_pos=zeros((B,), i32),
      destination_xy=t(arrays["destination_xy"], f32),
      npc_xy=t(arrays["npc_xy"], f32),
      npc_yaw=t(arrays["npc_yaw"], f32),
      npc_speed=zeros((B, K)),
      npc_wp=t(arrays["npc_wp"], i32),
      npc_alive=t(arrays["npc_alive"], torch.bool),
      ped_xy=t(arrays["ped_xy"], f32),
      ped_yaw=t(arrays["ped_yaw"], f32),
      ped_alive=t(arrays["ped_alive"], torch.bool),
      time=zeros((B,)),
      step=zeros((B,), i32),
      collision=zeros((B,)),
      lane_invasion=zeros((B,), i32),
      off_lane_prev=zeros((B,), torch.bool),
      red_light_invasion=zeros((B,), i32),
      at_red_prev=zeros((B,), torch.bool),
      hero_wait=zeros((B,), i32),
      npc_wait=zeros((B, K), i32),
      npc_stall=zeros((B, K), i32),
      pid_lat=PIDState.zero_batch(B, device),
      pid_lon=PIDState.zero_batch(B, device),
      rng=keys.to(device),
  )


def init_scene_batch(
    town: TownMap,
    batch_size: int,
    *,
    num_vehicles=0,
    num_pedestrians=0,
    route_capacity: int = DEFAULT_ROUTE_CAPACITY,
    seed: int = 0,
    spawn_points: Optional[np.ndarray] = None,
    destinations: Optional[np.ndarray] = None,
    device="cuda",
) -> SceneState:
  """Vectorised initialisation of a whole scene batch (host-side numpy,
  one native BFS call for all routes), then one copy to ``device``.

  ``num_vehicles`` / ``num_pedestrians`` may be per-scene arrays [B]:
  actor arrays are padded to the batch max and alive-masked per scene.
  ``spawn_points`` / ``destinations`` [B] place each hero (indices modulo
  the town's spawn points); a given array skips its random draw, so the
  later draws (NPC placement, pedestrians) shift as in the JAX package.
  """
  device = torch.device(device)
  rng = np.random.RandomState(seed)
  B = int(batch_size)
  S = town.num_spawn_points

  nv = np.broadcast_to(np.asarray(num_vehicles, np.int32), (B,))
  npd = np.broadcast_to(np.asarray(num_pedestrians, np.int32), (B,))

  sp = (rng.randint(S, size=B) if spawn_points is None
        else np.asarray(spawn_points) % S)
  dp = (rng.randint(S, size=B) if destinations is None
        else np.asarray(destinations) % S)

  origin_wps = town.spawn_wp[sp]
  dest_wps = town.spawn_wp[dp]
  routes, lengths = plan_route_batch(town, origin_wps, dest_wps,
                                     route_capacity)

  # NPCs: per-scene distinct spawn indices, excluding the hero's.
  K = int(nv.max()) if B else 0
  npc_xy = np.zeros((B, K, 2), np.float32)
  npc_yaw = np.zeros((B, K), np.float32)
  npc_wp = np.zeros((B, K), np.int32)
  npc_alive = np.zeros((B, K), bool)
  if K > 0:
    # Exclude NPC-restricted roads and the hero's spawn from NPC placement.
    npc_ok_spawn = (town.wp_npc_ok[town.spawn_wp]
                    if town.wp_npc_ok is not None else np.ones(S, bool))
    scores = rng.rand(B, S) + np.where(npc_ok_spawn, 0.0, 10.0)[None, :]
    order = np.argsort(scores, axis=1)[:, :K + 1]
    keep = order != sp[:, None]
    picks = np.empty((B, K), dtype=np.int64)
    for b in range(B):  # tiny loop over B, vector ops inside
      picks[b] = order[b][keep[b]][:K]
    wp = town.spawn_wp[picks]
    npc_xy[:] = town.wp_xy[wp]
    npc_yaw[:] = town.wp_yaw[wp]
    npc_wp[:] = town.wp_next[wp, 0]
    npc_alive[:] = np.arange(K)[None, :] < nv[:, None]

  P = int(npd.max()) if B else 0
  ped_xy = np.zeros((B, P, 2), np.float32)
  ped_yaw = np.zeros((B, P), np.float32)
  ped_alive = np.zeros((B, P), bool)
  if P > 0:
    free = np.nonzero(~town.road_mask & ~town.obstacle_mask)
    sel = rng.randint(len(free[0]), size=(B, P))
    ped_xy[..., 0] = town.raster_origin[0] + free[0][sel] / town.raster_ppm
    ped_xy[..., 1] = town.raster_origin[1] + free[1][sel] / town.raster_ppm
    ped_yaw[:] = rng.uniform(-np.pi, np.pi, size=(B, P))
    ped_alive[:] = np.arange(P)[None, :] < npd[:, None]

  keys = rng_lib.PRNGKey(np.arange(seed, seed + B, dtype=np.int64))
  arrays = dict(
      hero_xy=town.wp_xy[origin_wps], hero_yaw=town.wp_yaw[origin_wps],
      hero_wp=origin_wps, route=routes, route_len=lengths,
      destination_xy=town.wp_xy[dest_wps], npc_xy=npc_xy, npc_yaw=npc_yaw,
      npc_wp=npc_wp, npc_alive=npc_alive, ped_xy=ped_xy, ped_yaw=ped_yaw,
      ped_alive=ped_alive)
  return _state_from_host(arrays, keys, B, device)

