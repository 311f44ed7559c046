"""Bird's-eye-view LIDAR splat: constants, rect selection and the plain
dense splat.

Port of the JAX package's ``ops/bev.py`` over a scene batch.  The 200x200x2
histogram (channel 0 "below": ground returns, channel 1 "above": obstacle
returns) is synthesised from scene geometry instead of ray-cast points;
see the JAX module for the derivation.

What lives here:
  - the constants and static images (pixel centres, ground ring, expected
    obstacle hits);
  - nearest-k selection of wall / road rects and actor boxes;
  - ``splat_lidar``: the dense half-plane splat, the plain version the
    tests hold against the JAX package;
  - ``gather_inputs``: the per-scene kernel inputs (hero pose, selected
    rects and boxes) for the CUDA splat in ``ops/bev_cuda.py``.

The interval and blocked splat methods of the JAX package are not ported
yet.
"""

import functools
import math

import numpy as np
import torch

from oatomobile_torch.sim.util import constant, norm, take

# Reference splat parameters (utils/carla.py:165-233 of the reference).
PIXELS_PER_METER = 2
HIST_MAX_PER_PIXEL = 5
METERS_MAX = 50
BEV_SIZE = METERS_MAX * 2 * PIXELS_PER_METER  # 200
# The reference's bins: np.linspace(-50, 51, 201) -> bin width 101/200.
BIN_WIDTH = (2 * METERS_MAX + 1) / BEV_SIZE  # 0.505 m
BIN_LOW = -float(METERS_MAX)

# Reference LIDAR sensor config (defaults.py:118-135 of the reference).
LIDAR_Z = 2.5
LIDAR_CHANNELS = 32
LIDAR_PPS = 200_000
LIDAR_ROT_HZ = 20
LIDAR_UPPER_FOV = 10.0
LIDAR_LOWER_FOV = -30.0

# Points per channel per rotation.
_PTS_PER_CHANNEL = LIDAR_PPS // (LIDAR_ROT_HZ * LIDAR_CHANNELS)  # 312

# Sidewalk clear margin beyond the road edge (maps/builder.py SIDEWALK).
SIDEWALK = 2.0

# Actor and static-geometry budgets, nearest first (sized by measurement
# in the JAX package's tests; the per-town wall/road budgets on
# WorldParams are the effective counts).
MAX_BEV_VEHICLES = 24
MAX_BEV_PEDESTRIANS = 16
MAX_BEV_WALLS = 32
MAX_BEV_ROADS = 24


def _pixel_centers() -> np.ndarray:
  """[200] world-offsets of pixel centers along one axis (hero frame),
  float64; every splat uses its float32 rounding."""
  return BIN_LOW + (np.arange(BEV_SIZE) + 0.5) * BIN_WIDTH


@functools.lru_cache(maxsize=None)
def pixel_centers(device: torch.device) -> torch.Tensor:
  """[200] float32 pixel-centre offsets (the table every splat shares),
  made once per device."""
  return torch.as_tensor(_pixel_centers().astype(np.float32), device=device)


@functools.lru_cache(maxsize=1)
def ground_ring_image() -> np.ndarray:
  """Static expected ground-return histogram [200, 200] in [0, 1]: every
  beam channel with negative elevation paints a circle of ground hits of
  radius z/tan(|e|), histogrammed like the reference splat and clipped at
  5/pixel."""
  elev = np.linspace(LIDAR_UPPER_FOV, LIDAR_LOWER_FOV, LIDAR_CHANNELS)
  hist = np.zeros((BEV_SIZE, BEV_SIZE), dtype=np.float64)
  edges = BIN_LOW + np.arange(BEV_SIZE + 1) * BIN_WIDTH
  for e in elev:
    if e >= -0.5:
      continue
    r = LIDAR_Z / np.tan(np.deg2rad(-e))
    if r > METERS_MAX * 1.45:  # entirely out of range (diag margin)
      continue
    theta = np.linspace(0.0, 2 * np.pi, _PTS_PER_CHANNEL, endpoint=False)
    xs = r * np.cos(theta)
    ys = r * np.sin(theta)
    h, _, _ = np.histogram2d(xs, ys, bins=(edges, edges))
    hist += h
  hist = np.minimum(hist, HIST_MAX_PER_PIXEL) / HIST_MAX_PER_PIXEL
  return hist.astype(np.float32)


def _expected_obstacle_hits(r: torch.Tensor) -> torch.Tensor:
  """Expected LIDAR hits per pixel on a ~1.5 m tall vertical surface at
  range r (float32, as the JAX package computes it)."""
  r = torch.clamp_min(r, 1.0)
  az = _PTS_PER_CHANNEL * BIN_WIDTH / (2 * math.pi * r)
  span = (torch.atan2(torch.full_like(r, LIDAR_Z), r) -
          torch.atan2(torch.full_like(r, LIDAR_Z - 1.6), r))
  spacing = np.float32((LIDAR_UPPER_FOV - LIDAR_LOWER_FOV) /
                       LIDAR_CHANNELS) * np.float32(np.pi / 180)
  channels = span / float(spacing)
  return az * torch.clamp_min(channels, 1.0)


@functools.lru_cache(maxsize=1)
def const_images():
  """(counts, ground) [200, 200] float32 numpy: the "above" value of an
  occupied pixel (clipped expected hits / 5, zero beyond 50 m) and the
  ground ring.  The kernel and its plain version read these tables."""
  c = _pixel_centers().astype(np.float32)
  lx = np.broadcast_to(c[:, None], (BEV_SIZE, BEV_SIZE))
  ly = np.broadcast_to(c[None, :], (BEV_SIZE, BEV_SIZE))
  rng = np.maximum(np.sqrt(lx * lx + ly * ly), 1.0)
  az = _PTS_PER_CHANNEL * BIN_WIDTH / (2 * np.pi * rng)
  span = np.arctan2(LIDAR_Z, rng) - np.arctan2(LIDAR_Z - 1.6, rng)
  channels = span / np.deg2rad(
      (LIDAR_UPPER_FOV - LIDAR_LOWER_FOV) / LIDAR_CHANNELS)
  hits = az * np.maximum(channels, 1.0)
  counts = np.minimum(hits, float(HIST_MAX_PER_PIXEL)) / HIST_MAX_PER_PIXEL
  counts = np.where(np.sqrt(lx * lx + ly * ly) <= METERS_MAX, counts, 0.0)
  return counts.astype(np.float32), ground_ring_image()


def _hero_frame_grid(hero_xy: torch.Tensor,
                     hero_yaw: torch.Tensor) -> torch.Tensor:
  """[B, 200, 200, 2] world coordinates of every BEV pixel center."""
  c = pixel_centers(hero_xy.device)
  lx = c[None, :, None]          # forward offsets  (rows)
  ly = c[None, None, :]          # lateral offsets  (cols)
  cos_y = torch.cos(hero_yaw)[:, None, None]
  sin_y = torch.sin(hero_yaw)[:, None, None]
  wx = hero_xy[:, 0, None, None] + cos_y * lx - sin_y * ly
  wy = hero_xy[:, 1, None, None] + sin_y * lx + cos_y * ly
  return torch.stack([wx, wy], dim=-1)


def _boxes_occupancy(local_centers_uv, yaw_rel, half_lw,
                     alive) -> torch.Tensor:
  """[B, 200, 200] bool occupancy of K oriented boxes given in the hero
  frame (centers [B, K, 2], yaw_rel [B, K], half_lw [B, K, 2], alive
  [B, K])."""
  c = pixel_centers(local_centers_uv.device)
  px = c[None, :, None, None]   # [1, 200, 1, 1] forward
  py = c[None, None, :, None]   # [1, 1, 200, 1] lateral
  cos_r = torch.cos(yaw_rel)[:, None, None, :]
  sin_r = torch.sin(yaw_rel)[:, None, None, :]
  bx = local_centers_uv[:, None, None, :, 0]
  by = local_centers_uv[:, None, None, :, 1]
  # Half-plane form: centers folded into per-box constants.
  cu = cos_r * bx + sin_r * by
  cv = -sin_r * bx + cos_r * by
  u = cos_r * px + sin_r * py - cu
  v = cos_r * py - sin_r * px - cv
  inside = ((u.abs() <= half_lw[:, None, None, :, 0]) &
            (v.abs() <= half_lw[:, None, None, :, 1]) &
            alive[:, None, None, :])
  return torch.any(inside, dim=-1)


def _nearest_k(xy_rel: torch.Tensor, alive: torch.Tensor,
               k: int) -> torch.Tensor:
  """[B, k] indices of the k nearest alive actors, nearest first.

  A stable ascending sort: ties keep the lower index first, as
  ``lax.top_k`` orders them (torch.topk promises no tie order)."""
  d = torch.where(alive, norm(xy_rel), float("inf"))
  k = min(k, d.shape[-1])
  return torch.sort(d, dim=-1, stable=True).indices[:, :k]


def rect_distance(rects: torch.Tensor, point: torch.Tensor) -> torch.Tensor:
  """[B, R] point-to-ORIENTED-rect distance of each scene's ``point``
  [B, 2] to every rect [R, 6]."""
  dx = point[:, 0, None] - rects[None, :, 0]
  dy = point[:, 1, None] - rects[None, :, 1]
  u = rects[None, :, 4] * dx + rects[None, :, 5] * dy
  v = -rects[None, :, 5] * dx + rects[None, :, 4] * dy
  du = torch.clamp_min(u.abs() - rects[None, :, 2], 0.0)
  dv = torch.clamp_min(v.abs() - rects[None, :, 3], 0.0)
  return torch.sqrt(du * du + dv * dv)


def nearest_rects(rects: torch.Tensor, point: torch.Tensor, k: int,
                  max_range: float = METERS_MAX * 1.5) -> torch.Tensor:
  """[B, k, 6] oriented rects (cx, cy, hx, hy, cos, sin) nearest to each
  scene's ``point`` by point-to-rect distance.  Selections beyond
  ``max_range`` are pushed out so padded slots never rasterise; ties at
  the k-th slot go to the lower index (stable sort, as ``lax.top_k``)."""
  d = rect_distance(rects, point)
  k = min(k, rects.shape[0])
  d_sorted, idx = torch.sort(d, dim=-1, stable=True)
  d_sorted, idx = d_sorted[:, :k], idx[:, :k]
  sel = rects[idx]                                            # [B, k, 6]
  valid = d_sorted <= max_range
  pushed = constant((-1e6, -1e6, 0.0, 0.0, 1.0, 0.0), rects.device)
  return torch.where(valid[..., None], sel, pushed)


def rects_occupancy(grid_world: torch.Tensor, rects: torch.Tensor,
                    inflate: float = 0.0) -> torch.Tensor:
  """[B, H, W] bool: grid points [B, H, W, 2] inside any of the scene's
  oriented rects [B, R, 6], half-extents grown by ``inflate``.  Half-plane
  form: ``u = cr*x + sr*y - cu`` with the center folded into a per-rect
  constant."""
  r = rects[:, None, None, :, :]
  cr, sr = r[..., 4], r[..., 5]
  cu = cr * r[..., 0] + sr * r[..., 1]
  cv = -sr * r[..., 0] + cr * r[..., 1]
  x = grid_world[..., 0, None]
  y = grid_world[..., 1, None]
  u = cr * x + sr * y - cu
  v = cr * y - sr * x - cv
  inside = ((u.abs() <= r[..., 2] + inflate) &
            (v.abs() <= r[..., 3] + inflate))
  return torch.any(inside, dim=-1)


def _hero_frame(rel: torch.Tensor, cos_y: torch.Tensor,
                sin_y: torch.Tensor) -> torch.Tensor:
  u = cos_y[:, None] * rel[..., 0] + sin_y[:, None] * rel[..., 1]
  v = -sin_y[:, None] * rel[..., 0] + cos_y[:, None] * rel[..., 1]
  return torch.stack([u, v], dim=-1)


def splat_lidar(params, state, *,
                max_vehicles: int = MAX_BEV_VEHICLES,
                max_pedestrians: int = MAX_BEV_PEDESTRIANS) -> torch.Tensor:
  """[B, 200, 200, 2] BEV LIDAR histogram by the dense half-plane test
  (the JAX package's ``splat_lidar(method="dense")``).

  Axis 1 runs along the car's forward axis, axis 2 lateral; channel 0 =
  below (ground), channel 1 = above (obstacles); values in [0, 1].  The
  plain version the tests use; on a card the sensor goes through the
  kernel of ``ops/bev_cuda.py``."""
  hero_xy, hero_yaw = state.hero_xy, state.hero_yaw
  device = hero_xy.device
  grid_world = _hero_frame_grid(hero_xy, hero_yaw)

  # Building walls: the only static surfaces a LIDAR returns from.
  wall_sel = nearest_rects(params.map["wall_rects"], hero_xy,
                           min(MAX_BEV_WALLS, params.wall_budget),
                           max_range=METERS_MAX * 1.04)
  # Ground returns exist only on/near the road corridors (road + sidewalk).
  road_sel = nearest_rects(params.map["road_rects"], hero_xy,
                           min(MAX_BEV_ROADS, params.road_budget))
  cos_y, sin_y = torch.cos(hero_yaw), torch.sin(hero_yaw)
  occupied = rects_occupancy(grid_world, wall_sel)
  open_ground = rects_occupancy(grid_world, road_sel, inflate=SIDEWALK)

  # Vehicle boxes (nearest MAX_BEV_VEHICLES only).
  if state.num_npcs > 0:
    rel = state.npc_xy - hero_xy[:, None, :]
    sel = _nearest_k(rel, state.npc_alive, max_vehicles)
    rel_sel = take(rel, sel)
    centers = _hero_frame(rel_sel, cos_y, sin_y)
    yaw_rel = take(state.npc_yaw, sel) - hero_yaw[:, None]
    half = torch.stack([
        (params.vehicle.length / 2.0).expand(sel.shape),
        (params.vehicle.width / 2.0).expand(sel.shape)
    ], dim=-1)
    in_range = norm(rel_sel) < (METERS_MAX * 1.5)
    alive = take(state.npc_alive, sel) & in_range
    occupied = occupied | _boxes_occupancy(centers, yaw_rel, half, alive)

  if state.num_pedestrians > 0:
    rel = state.ped_xy - hero_xy[:, None, :]
    sel = _nearest_k(rel, state.ped_alive, max_pedestrians)
    centers = _hero_frame(take(rel, sel), cos_y, sin_y)
    half = torch.full(sel.shape + (2,), 0.35, device=device)
    occupied = occupied | _boxes_occupancy(
        centers, torch.zeros(sel.shape, device=device), half,
        take(state.ped_alive, sel))

  # Range-dependent expected hit counts.
  c = pixel_centers(device)
  rng = torch.sqrt(c[:, None]**2 + c[None, :]**2)
  above_counts = torch.clamp_max(_expected_obstacle_hits(rng),
                                 float(HIST_MAX_PER_PIXEL))
  in_range = rng <= METERS_MAX
  above = torch.where(occupied & in_range,
                      above_counts / HIST_MAX_PER_PIXEL, 0.0)

  ground = torch.as_tensor(ground_ring_image(), device=device)
  below = torch.where(occupied | ~open_ground, 0.0, ground)
  return torch.stack([below, above], dim=-1)


def gather_inputs(params, state):
  """The kernel's inputs for every scene: nearest-k rect selection and box
  assembly, with the selection semantics of ``splat_lidar`` (the torch
  counterpart of the JAX package's ``bev_pallas.gather_inputs``).

  Returns:
    hero [B, 4] (x, y, cos yaw, sin yaw); walls [B, NW, 6]; roads
    [B, NR, 6] inflated by the sidewalk margin; boxes [B, NV, 6] (vehicles
    then pedestrians, world frame; a zero row when the scene has no
    actors).  Empty slots have half-length 0.
  """
  hero_xy, hero_yaw = state.hero_xy, state.hero_yaw
  B = hero_xy.shape[0]
  device = hero_xy.device
  hero = torch.stack([hero_xy[:, 0], hero_xy[:, 1], torch.cos(hero_yaw),
                      torch.sin(hero_yaw)], dim=-1)
  walls = nearest_rects(params.map["wall_rects"], hero_xy,
                        min(MAX_BEV_WALLS, params.wall_budget),
                        max_range=METERS_MAX * 1.04)
  roads = nearest_rects(params.map["road_rects"], hero_xy,
                        min(MAX_BEV_ROADS, params.road_budget))
  # Pre-inflate corridor chords by the sidewalk margin.
  grow = torch.where(roads[..., 2:3] > 0.0, SIDEWALK, 0.0)
  roads = torch.cat([roads[..., :2], roads[..., 2:4] + grow, roads[..., 4:]],
                    dim=-1)

  boxes = []
  if state.num_npcs > 0:
    rel = state.npc_xy - hero_xy[:, None, :]
    sel = _nearest_k(rel, state.npc_alive, MAX_BEV_VEHICLES)
    alive = take(state.npc_alive, sel)
    in_range = (norm(take(rel, sel)) < METERS_MAX * 1.5) & alive
    half_l = torch.where(in_range, params.vehicle.length / 2.0, 0.0)
    xy = take(state.npc_xy, sel)
    yaw = take(state.npc_yaw, sel)
    boxes.append(torch.stack([
        xy[..., 0], xy[..., 1], half_l,
        (params.vehicle.width / 2.0).expand_as(half_l),
        torch.cos(yaw), torch.sin(yaw)
    ], dim=-1))
  if state.num_pedestrians > 0:
    rel = state.ped_xy - hero_xy[:, None, :]
    sel = _nearest_k(rel, state.ped_alive, MAX_BEV_PEDESTRIANS)
    in_range = (norm(take(rel, sel)) < METERS_MAX * 1.5) & \
        take(state.ped_alive, sel)
    half = torch.where(in_range, 0.35, 0.0)
    xy = take(state.ped_xy, sel)
    boxes.append(torch.stack([
        xy[..., 0], xy[..., 1], half, half, torch.ones_like(half),
        torch.zeros_like(half)
    ], dim=-1))
  if boxes:
    box_arr = torch.cat(boxes, dim=1)
  else:
    box_arr = torch.zeros((B, 1, 6), dtype=torch.float32, device=device)
  return hero, walls, roads, box_arr
