"""Array-form town map assets.

This module replaces the reference's entire OpenDrive/CARLA map stack
(upstream oatomobile/utils/graphics.py:430-711 rasterization,
``world.get_map().get_spawn_points()``, waypoint queries, and the
``GlobalRoutePlanner`` A* of utils/carla.py:703-744) with precomputed
dense arrays, so that *every* map query in the hot loop is a gather:

  - lane-graph waypoints (positions, headings, successor table),
  - nearest-waypoint raster (O(1) localisation),
  - road / lane-boundary occupancy rasters (lane invasion + BEV synthesis),
  - spawn points, traffic lights with phase groups.

Town geometry is generated procedurally (see :mod:`towns`): CARLA's
OpenDrive files are not redistributable and the CARLA binary is not part of
this framework; what matters for API/behaviour parity is the *structure*
(waypoint graph + rasters + spawn indices) that all downstream components
consume.
"""

import dataclasses
from typing import Optional

import numpy as np

# Maximum successors per waypoint (straight / left / right at a junction).
MAX_NEXT = 4


@dataclasses.dataclass
class TownMap:
  """Host-side (numpy) array-form map. Converted to device arrays once per
  environment via :meth:`tensors`."""

  name: str
  lane_width: float

  # --- Lane graph -----------------------------------------------------
  wp_xy: np.ndarray         # [W, 2] f32 lane-centerline points (~2 m apart)
  wp_yaw: np.ndarray        # [W]    f32 radians, direction of travel
  wp_next: np.ndarray       # [W, MAX_NEXT] i32 successor ids (-1 padded)
  wp_num_next: np.ndarray   # [W]    i32
  wp_road_id: np.ndarray    # [W]    i32 street id (junction connectors: own)
  wp_lane_id: np.ndarray    # [W]    i32 signed lane id (CARLA-style)
  wp_is_junction: np.ndarray  # [W]  bool
  wp_speed_limit: np.ndarray  # [W]  f32 m/s
  wp_tl: np.ndarray         # [W]    i32 traffic light governing wp (-1 none)

  # --- Spawn points ----------------------------------------------------
  spawn_wp: np.ndarray      # [S] i32 waypoint index per spawn point

  # --- Traffic lights --------------------------------------------------
  tl_xy: np.ndarray         # [L, 2] f32
  tl_group: np.ndarray      # [L] i32 phase group (0 or 1) within junction
  tl_offset: np.ndarray     # [L] f32 per-junction phase offset (seconds)

  # --- Rasters ----------------------------------------------------------
  raster_origin: np.ndarray  # [2] world xy of pixel (0, 0) center
  raster_ppm: float          # pixels per meter
  road_mask: np.ndarray      # [H, Wd] bool drivable area
  lane_mask: np.ndarray      # [H, Wd] bool lane boundary lines
  obstacle_mask: np.ndarray  # [H, Wd] bool static obstacles (buildings)
  wall_mask: np.ndarray      # [H, Wd] bool street-facing building walls
  nearest_wp: np.ndarray     # [H, Wd] i32 nearest waypoint id per cell

  # Static geometry as ORIENTED rects (cx, cy, hx, hy, cos t, sin t) — the
  # hot path uses these instead of raster gathers (the BEV splat kernel
  # tests pixels against rects held in shared memory).  Oriented (not axis-aligned) so curved
  # roads/roundabouts decompose into a handful of chords:
  wall_rects: np.ndarray = None     # [Rw, 6] street-facing wall bands
  road_rects: np.ndarray = None     # [Rr, 6] drivable corridors (chords)
  # [S] i32 spec-edge index each spawn point sits on (feature lookups for
  # benchmark spawn pinning); -1 for legacy caches.
  spawn_edge: np.ndarray = None
  # Measured rect budgets: the max number of wall rects within 52 m / road
  # rects within 75 m of any lane waypoint (BEV selection counts).
  wall_budget: int = 24
  road_budget: int = 16
  # [W] bool: NPC traffic permitted (False on restricted roads, e.g. the
  # Town03 hairpin pass).  None for legacy caches -> all True.
  wp_npc_ok: np.ndarray = None

  _device: Optional[dict] = dataclasses.field(default=None, repr=False)

  @property
  def num_waypoints(self) -> int:
    return int(self.wp_xy.shape[0])

  @property
  def num_spawn_points(self) -> int:
    return int(self.spawn_wp.shape[0])

  def spawn_transform(self, index: int):
    """Returns (location_xyz, rotation_pyr_deg) of a spawn point, mirroring
    ``carla.Transform`` observables."""
    wp = int(self.spawn_wp[index % self.num_spawn_points])
    x, y = self.wp_xy[wp]
    yaw_deg = float(np.rad2deg(self.wp_yaw[wp]))
    return (np.array([x, y, 0.0], dtype=np.float32),
            np.array([0.0, yaw_deg, 0.0], dtype=np.float32))

  def world_to_pixel(self, xy: np.ndarray) -> np.ndarray:
    """World xy -> integer raster indices (row=x, col=y layout)."""
    rel = (np.asarray(xy) - self.raster_origin) * self.raster_ppm
    idx = np.round(rel).astype(np.int32)
    h, w = self.road_mask.shape
    return np.stack(
        [np.clip(idx[..., 0], 0, h - 1),
         np.clip(idx[..., 1], 0, w - 1)], axis=-1)

  def wp_bend(self) -> np.ndarray:
    """[W] f32: max |heading change| over the next-3 first-successor
    chain of each waypoint.  The chain is static per map, so the NPC
    curvature-lookahead brake (sim/traffic.py) reads this with ONE
    gather instead of walking wp_next/wp_yaw seven times per vehicle
    per step."""
    yaw_here = self.wp_yaw.astype(np.float32)
    bend = np.zeros_like(yaw_here)
    nxt = self.wp_next[:, 0].astype(np.int64)
    cur = nxt
    for _ in range(3):
      safe = np.maximum(cur, 0)
      dy = self.wp_yaw[safe].astype(np.float32) - yaw_here
      dy = np.abs(np.arctan2(np.sin(dy), np.cos(dy),
                             dtype=np.float32).astype(np.float32))
      bend = np.maximum(bend, np.where(cur >= 0, dy, 0.0))
      cur = self.wp_next[safe, 0].astype(np.int64)
    return bend.astype(np.float32)

  def wp_path_xy(self, length: int = 6) -> np.ndarray:
    """[W, length, 2] f32: positions of the next-``length``
    first-successor chain starting AT each waypoint.  Static per map —
    the NPC path-aware blocking check (sim/traffic.py) reads the whole
    upcoming-lane corridor with ONE gather instead of walking
    wp_next/wp_xy ``length`` dependent times per vehicle per step (the
    same trick as `wp_bend`).  Missing successors repeat the last valid
    position (a harmless duplicate point)."""
    W = self.wp_xy.shape[0]
    out = np.zeros((W, length, 2), np.float32)
    cur = np.arange(W, dtype=np.int64)
    for i in range(length):
      safe = np.maximum(cur, 0)
      out[:, i] = self.wp_xy[safe]
      cur = np.where(cur >= 0, self.wp_next[safe, 0].astype(np.int64), cur)
    return out

  def wp_path_junction(self, length: int = 6) -> np.ndarray:
    """[W, length] bool: junction flag of the next-``length``
    first-successor chain starting AT each waypoint (companion to
    `wp_path_xy`).  Lets a vehicle see 'the box is on my path' one
    gather before entering — the don't-block-the-box gate
    (sim/traffic.py) holds it outside while its path through the
    junction is occupied."""
    W = self.wp_xy.shape[0]
    out = np.zeros((W, length), bool)
    cur = np.arange(W, dtype=np.int64)
    for i in range(length):
      safe = np.maximum(cur, 0)
      out[:, i] = self.wp_is_junction[safe]
      cur = np.where(cur >= 0, self.wp_next[safe, 0].astype(np.int64), cur)
    return out

  def wp_tl_ahead(self, length: int = 20) -> np.ndarray:
    """[W] i32: id of the first traffic light governing any waypoint on
    the next-``length`` first-successor chain (self included), -1 if
    none.  The per-waypoint governed zone spans only the last ~5 m of
    each approach, so a queue follower 3+ cars back at a saturated
    light stands on UNgoverned waypoints — this array lets the tow-away
    stall integrator (sim/traffic.py) recognise 'I am queued for that
    red light 40 m ahead' with a single gather and pause instead of
    accumulating toward a despawn (ADVICE r4: legitimately queued NPCs
    were towed after 2-3 slow-discharge cycles)."""
    W = self.wp_xy.shape[0]
    out = np.full((W,), -1, np.int32)
    cur = np.arange(W, dtype=np.int64)
    for _ in range(length):
      safe = np.maximum(cur, 0)
      tl = self.wp_tl[safe].astype(np.int32)
      out = np.where((out < 0) & (cur >= 0), tl, out)
      cur = np.where(cur >= 0, self.wp_next[safe, 0].astype(np.int64), cur)
    return out

  def tensors(self, device) -> dict:
    """Returns (and caches per device) the dict of map tensors used by the
    step.  Same keys and dtypes as the JAX package's ``device_arrays``:
    float32 -> torch.float32, int32 -> torch.int32, bool -> torch.bool."""
    import torch
    device = torch.device(device)
    if self._device is None:
      self._device = {}
    if device not in self._device:
      f32, i32 = torch.float32, torch.int32

      def t(x, dtype=None):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

      self._device[device] = dict(
          wp_xy=t(self.wp_xy, f32),
          wp_yaw=t(self.wp_yaw, f32),
          wp_bend=t(self.wp_bend(), f32),
          wp_path_xy=t(self.wp_path_xy(), f32),
          wp_path_junction=t(self.wp_path_junction()),
          wp_next=t(self.wp_next, i32),
          wp_num_next=t(self.wp_num_next, i32),
          wp_road_id=t(self.wp_road_id, i32),
          wp_lane_id=t(self.wp_lane_id, i32),
          wp_is_junction=t(self.wp_is_junction),
          wp_speed_limit=t(self.wp_speed_limit, f32),
          wp_npc_ok=t(self.wp_npc_ok if self.wp_npc_ok is not None else
                      np.ones(len(self.wp_xy), bool)),
          wp_tl=t(self.wp_tl, i32),
          wp_tl_ahead=t(self.wp_tl_ahead(), i32),
          spawn_wp=t(self.spawn_wp, i32),
          tl_xy=t(self.tl_xy, f32),
          tl_group=t(self.tl_group, i32),
          tl_offset=t(self.tl_offset, f32),
          raster_origin=t(self.raster_origin, f32),
          raster_ppm=t(np.float32(self.raster_ppm), f32),
          road_mask=t(self.road_mask),
          lane_mask=t(self.lane_mask),
          obstacle_mask=t(self.obstacle_mask),
          wall_mask=t(self.wall_mask),
          wall_rects=t(self.wall_rects, f32),
          road_rects=t(self.road_rects, f32),
          nearest_wp=t(self.nearest_wp, i32),
          lane_width=t(np.float32(self.lane_width), f32),
      )
    return self._device[device]
