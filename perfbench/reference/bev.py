"""Bird's-eye-view LIDAR of the reference: the splat's constants and
static images, and the kernel's inputs (hero pose, nearest wall and road
rects, actor boxes) for ``reference/splat.py``.

A frozen copy of the program's ``ops/bev.py`` (its constants, images,
nearest-k selection and ``gather_inputs``).
"""

import functools
import math

import numpy as np
import torch

from perfbench.reference.sim.util import constant, norm, take

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


@functools.lru_cache(maxsize=None)
def ground_ring(device: torch.device) -> torch.Tensor:
  """``ground_ring_image`` as a tensor on ``device``, made once per device
  (a copy from host memory cannot sit inside a captured step)."""
  return torch.as_tensor(ground_ring_image(), device=device)


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
