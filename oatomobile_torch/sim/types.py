"""World-model state: static parameters and a batch of scene states.

The JAX package keeps one scene as a pytree and ``vmap``s over scenes;
here a ``SceneState`` holds the whole scene batch, every field with an
explicit leading ``[B, ...]`` axis.  All shapes are static: fixed
NPC/pedestrian capacities with alive-masks, fixed route capacity with
saturation padding.

Scalar parameters are 0-dim float32 tensors on the state's device, so
every expression rounds in float32 exactly as the JAX package's float32
scalars do (a Python float would first combine with other constants in
float64).
"""

import dataclasses
from typing import Any, Dict, Mapping

import numpy as np
import torch

from oatomobile_torch import rng as rng_lib


def _f32(value, device) -> torch.Tensor:
  return torch.tensor(np.float32(value), dtype=torch.float32, device=device)


def _map_fields(obj, fn):
  """Applies ``fn`` to every tensor field of a dataclass (recursively)."""
  changes = {}
  for f in dataclasses.fields(obj):
    value = getattr(obj, f.name)
    if isinstance(value, torch.Tensor):
      changes[f.name] = fn(value)
    elif dataclasses.is_dataclass(value):
      changes[f.name] = _map_fields(value, fn)
    elif isinstance(value, dict):
      changes[f.name] = {k: fn(v) for k, v in value.items()}
  return dataclasses.replace(obj, **changes)


class _TensorDataclass:
  """``replace`` and ``to(device)`` for the dataclasses below."""

  def replace(self, **changes):
    return dataclasses.replace(self, **changes)

  def to(self, device):
    return _map_fields(self, lambda t: t.to(device))


@dataclasses.dataclass
class VehicleSpec(_TensorDataclass):
  """Kinematic-bicycle parameters calibrated to CARLA-like behaviour
  (mustang hero, generic traffic): full-throttle 0-50 km/h in ~5 s, top
  speed ~90 km/h, brake decel ~8 m/s^2."""
  length: torch.Tensor
  width: torch.Tensor
  wheelbase: torch.Tensor
  max_steer_rad: torch.Tensor   # 45 deg at |steer|=1
  max_accel: torch.Tensor       # m/s^2 at full throttle
  max_brake: torch.Tensor       # m/s^2 at full brake
  drag: torch.Tensor            # v^2 drag coefficient
  roll: torch.Tensor            # rolling resistance m/s^2

  @classmethod
  def make(cls, device) -> "VehicleSpec":
    return cls(length=_f32(4.7, device), width=_f32(2.0, device),
               wheelbase=_f32(2.85, device),
               max_steer_rad=_f32(0.785398, device),
               max_accel=_f32(3.5, device), max_brake=_f32(8.0, device),
               drag=_f32(0.0054, device), roll=_f32(0.1, device))


@dataclasses.dataclass
class WorldParams(_TensorDataclass):
  """Static world configuration: map tensors + scalar knobs.

  ``map`` is the dict produced by ``TownMap.tensors(device)``.
  ``wall_budget``/``road_budget`` are the per-town rect counts the BEV
  splat selects (Python ints: they fix tensor shapes)."""
  map: Dict[str, Any]
  vehicle: VehicleSpec
  dt: torch.Tensor                       # simulation delta seconds (1/fps)
  npc_target_speed: torch.Tensor         # m/s for background traffic
  tl_green: torch.Tensor                 # traffic light phase durations (s)
  tl_yellow: torch.Tensor
  proximity_vehicle_threshold: torch.Tensor  # 10 m
  proximity_tlight_threshold: torch.Tensor   # 5 m
  wall_budget: int = 24
  road_budget: int = 16

  @property
  def device(self) -> torch.device:
    return self.dt.device


PID_WINDOW = 30  # CARLA's controller keeps a 30-sample error deque.


@dataclasses.dataclass
class PIDState(_TensorDataclass):
  """Sliding error window + previous error for a batch of PID
  controllers (CARLA's bounded ``deque(maxlen=30)``, see the JAX
  package's ``sim/types.py`` for why the window matters)."""
  err_buf: torch.Tensor    # [B, PID_WINDOW] f32, ring of recent errors
  prev_error: torch.Tensor  # [B] f32

  @classmethod
  def zero_batch(cls, batch_size: int, device) -> "PIDState":
    return cls(
        err_buf=torch.zeros((batch_size, PID_WINDOW), dtype=torch.float32,
                            device=device),
        prev_error=torch.zeros((batch_size,), dtype=torch.float32,
                               device=device))


@dataclasses.dataclass
class SceneState(_TensorDataclass):
  """Dynamic state of B scenes (one hero + traffic each).  Shapes below
  omit the leading [B] axis every field has."""

  # --- Hero -------------------------------------------------------------
  hero_xy: torch.Tensor        # [2] f32
  hero_yaw: torch.Tensor       # []  f32 radians
  hero_speed: torch.Tensor     # []  f32 m/s (forward, >= 0)
  hero_vel: torch.Tensor       # [2] f32 world-frame velocity (derived)
  hero_accel: torch.Tensor     # [2] f32 world-frame acceleration (derived)
  hero_yaw_rate: torch.Tensor  # []  f32 rad/s (derived)
  hero_control: torch.Tensor   # [3] f32 last applied (throttle, steer, brake)
  hero_wp: torch.Tensor        # []  i32 nearest waypoint id

  # --- Route ------------------------------------------------------------
  route: torch.Tensor          # [R] i32 waypoint ids (padded w/ destination)
  route_len: torch.Tensor      # []  i32
  route_pos: torch.Tensor      # []  i32 current progress index
  destination_xy: torch.Tensor  # [2] f32

  # --- Background vehicles (fixed capacity K, alive-masked) -------------
  npc_xy: torch.Tensor         # [K, 2] f32
  npc_yaw: torch.Tensor        # [K]    f32
  npc_speed: torch.Tensor      # [K]    f32
  npc_wp: torch.Tensor         # [K]    i32 target waypoint
  npc_alive: torch.Tensor      # [K]    bool

  # --- Pedestrians (fixed capacity P) ------------------------------------
  ped_xy: torch.Tensor         # [P, 2] f32
  ped_yaw: torch.Tensor        # [P]    f32
  ped_alive: torch.Tensor      # [P]    bool

  # --- Clock / events -----------------------------------------------------
  time: torch.Tensor           # [] f32 seconds since episode start
  step: torch.Tensor           # [] i32
  collision: torch.Tensor      # [] f32 impulse intensity this step
  lane_invasion: torch.Tensor  # [] i32 lane invasions fired this step
  off_lane_prev: torch.Tensor  # [] bool hero was outside its lane
  red_light_invasion: torch.Tensor  # [] i32 ran-a-red events this step
  at_red_prev: torch.Tensor    # [] bool hero was held at a red

  # --- Driver patience (yield-assertion counters) -------------------------
  hero_wait: torch.Tensor      # [] i32
  npc_wait: torch.Tensor       # [K] i32
  npc_stall: torch.Tensor      # [K] i32

  # --- Agent-side controller state ---------------------------------------
  pid_lat: PIDState
  pid_lon: PIDState

  # --- RNG ---------------------------------------------------------------
  rng: torch.Tensor            # [2] threefry key words (uint32 in int64)

  @property
  def batch_size(self) -> int:
    return self.hero_xy.shape[0]

  @property
  def num_npcs(self) -> int:
    return self.npc_xy.shape[-2]

  @property
  def num_pedestrians(self) -> int:
    return self.ped_xy.shape[-2]

  @property
  def route_capacity(self) -> int:
    return self.route.shape[-1]


def map_state(fn, *states: SceneState) -> SceneState:
  """``fn`` over corresponding tensor fields of one or more states (the
  counterpart of ``jax.tree.map`` over SceneState pytrees)."""

  def rec(objs):
    changes = {}
    for f in dataclasses.fields(objs[0]):
      values = [getattr(o, f.name) for o in objs]
      if isinstance(values[0], torch.Tensor):
        changes[f.name] = fn(*values)
      else:
        changes[f.name] = rec(values)
    return dataclasses.replace(objs[0], **changes)

  return rec(states)


_NP_TO_TORCH = {np.dtype(np.float32): torch.float32,
                np.dtype(np.int32): torch.int32,
                np.dtype(np.bool_): torch.bool}


def _tensor(value, device) -> torch.Tensor:
  arr = np.asarray(value)
  return torch.tensor(arr, dtype=_NP_TO_TORCH[arr.dtype], device=device)


def _field(d, name):
  return d[name] if isinstance(d, Mapping) else getattr(d, name)


def scene_state_from_numpy(d, device) -> SceneState:
  """SceneState from numpy arrays named as the JAX pytree's fields.

  ``d`` maps each field name to an array with the leading batch axis
  (``pid_lat``/``pid_lon`` to a mapping or object with ``err_buf`` and
  ``prev_error``); ``rng`` holds uint32 key words."""
  kwargs = {}
  for f in dataclasses.fields(SceneState):
    value = _field(d, f.name)
    if f.name in ("pid_lat", "pid_lon"):
      kwargs[f.name] = PIDState(
          err_buf=_tensor(_field(value, "err_buf"), device),
          prev_error=_tensor(_field(value, "prev_error"), device))
    elif f.name == "rng":
      kwargs[f.name] = rng_lib.from_numpy(value, device)
    else:
      kwargs[f.name] = _tensor(value, device)
  return SceneState(**kwargs)


def scene_state_to_numpy(state: SceneState) -> Dict[str, Any]:
  """The inverse of :func:`scene_state_from_numpy` (keys as uint32)."""
  out = {}
  for f in dataclasses.fields(SceneState):
    value = getattr(state, f.name)
    if isinstance(value, PIDState):
      out[f.name] = {"err_buf": value.err_buf.cpu().numpy(),
                     "prev_error": value.prev_error.cpu().numpy()}
    elif f.name == "rng":
      out[f.name] = rng_lib.to_numpy(value)
    else:
      out[f.name] = value.cpu().numpy()
  return out


def world_params_from_numpy(d, device) -> WorldParams:
  """WorldParams from numpy arrays named as the JAX pytree's fields:
  ``map`` a mapping of arrays, ``vehicle`` a mapping or object of
  scalars, ``wall_budget``/``road_budget`` ints."""
  vehicle = _field(d, "vehicle")
  return WorldParams(
      map={k: _tensor(v, device) for k, v in _field(d, "map").items()},
      vehicle=VehicleSpec(**{
          f.name: _tensor(np.float32(_field(vehicle, f.name)), device)
          for f in dataclasses.fields(VehicleSpec)}),
      **{name: _tensor(np.float32(_field(d, name)), device)
         for name in ("dt", "npc_target_speed", "tl_green", "tl_yellow",
                      "proximity_vehicle_threshold",
                      "proximity_tlight_threshold")},
      wall_budget=int(_field(d, "wall_budget")),
      road_budget=int(_field(d, "road_budget")))
