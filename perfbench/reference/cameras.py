"""The front camera of the reference: a frozen copy of the program's
analytic perspective camera (``sensors/cameras.py``): 180 x 320 pixels,
fov 90, 2.3 m above the ground, rays cast against the scene's
street-facing walls (6 m), vehicles (1.6 m) and pedestrians (1.8 m) as
extruded oriented boxes, the ground (road inside the nearest road
corridors) and the sky, coloured by the RGB palette.

Slab tests run over ``[B, W, K]`` (a ray's horizontal direction depends
on its column alone), the road test loops over the road rects, and the
depth resolve keeps a running minimum and the class of its first minimum.
"""

import functools

import numpy as np
import torch

from perfbench.reference import bev
from perfbench.reference.sim.types import SceneState, WorldParams
from perfbench.reference.sim.util import constant, take

IMAGE_H, IMAGE_W = 180, 320   # the reference's camera configs
FOV_DEG = 90.0
CAMERA_Z = 2.3
WALL_HEIGHT = 6.0
VEHICLE_HEIGHT = 1.6
PED_HEIGHT = 1.8
PED_HALF_SIZE = 0.35        # pedestrians' half length and half width
MAX_CAMERA_WALLS = 24
MAX_CAMERA_VEHICLES = 12
MAX_CAMERA_PEDS = 8
MAX_CAMERA_ROADS = 6
FAR = 120.0

# Class codes shared with the bird-view renderer.
SKY, GROUND, ROAD, LINE, BUILDING, VEHICLE, PED = 0, 1, 2, 3, 4, 5, 6

_RGB = np.asarray([
    [0.53, 0.75, 0.92],   # sky
    [0.35, 0.47, 0.30],   # ground/sidewalk
    [0.23, 0.23, 0.24],   # road
    [0.78, 0.78, 0.78],   # lane line
    [0.47, 0.39, 0.35],   # building
    [0.12, 0.23, 0.55],   # vehicle
    [0.78, 0.23, 0.23],   # pedestrian
], np.float32)

def _as_constant(palette: np.ndarray, device) -> torch.Tensor:
  return constant(tuple(map(tuple, palette.tolist())), device)


def _pixel_rays(device):
  """(u [W], w [H]) float32 ray components per image column and row
  (forward 1, lateral u to the right, vertical w up): ``jnp.linspace`` of
  the JAX module to a few ulps, made once per device."""
  half = float(np.tan(np.deg2rad(np.float32(FOV_DEG / 2.0))))
  vertical = float(np.float32(half) * np.float32(IMAGE_H) /
                   np.float32(IMAGE_W))
  u = np.linspace(-half, half, IMAGE_W, dtype=np.float32)
  w = np.linspace(vertical, -vertical, IMAGE_H, dtype=np.float32)
  return (constant(tuple(u.tolist()), device),
          constant(tuple(w.tolist()), device))


@functools.lru_cache(maxsize=None)
def _ray_tables(device: torch.device):
  """(u [W], norm_h [W], slope [H, W], t_ground [H, W]) on ``device``,
  made once (a copy from host data cannot sit inside a captured step):
  the horizontal norm of each column's ray, each pixel's rise per metre of
  horizontal travel, and its ground distance (inf at and above the
  horizon)."""
  u, w = _pixel_rays(device)
  norm_h = torch.sqrt(1.0 + u * u)
  slope = w[:, None] / norm_h[None, :]
  t_ground = torch.where(slope < -1e-4,
                         torch.full_like(slope, -CAMERA_Z) / slope,
                         float("inf"))
  return u, norm_h, slope, t_ground


def _ray_rect_distance(ox, oy, dx, dy, rects):
  """2-D slab test: ``[B, W, K]`` distance along each column's ray (dx, dy
  [B, W]) from each scene's camera (ox, oy [B]) to each of its ORIENTED
  rects [B, K, 6] (cx, cy, hx, hy, cos, sin); inf when missed.

  The ray is rotated into each rect's frame (rotation keeps the ray
  parameter t), then slab-tested against the axis-aligned box there."""
  eps = 1e-6
  cr, sr = rects[..., 4], rects[..., 5]                          # [B, K]
  rx = ox[:, None] - rects[..., 0]
  ry = oy[:, None] - rects[..., 1]
  oxr = (cr * rx + sr * ry)[:, None, :]                          # [B, 1, K]
  oyr = (-sr * rx + cr * ry)[:, None, :]
  cr, sr = cr[:, None, :], sr[:, None, :]
  dxr = cr * dx[..., None] + sr * dy[..., None]                  # [B, W, K]
  dyr = -sr * dx[..., None] + cr * dy[..., None]
  inv_dx = 1.0 / torch.where(dxr.abs() < eps, eps, dxr)
  inv_dy = 1.0 / torch.where(dyr.abs() < eps, eps, dyr)
  hx, hy = rects[:, None, :, 2], rects[:, None, :, 3]
  t1 = (-hx - oxr) * inv_dx
  t2 = (hx - oxr) * inv_dx
  t3 = (-hy - oyr) * inv_dy
  t4 = (hy - oyr) * inv_dy
  tmin = torch.maximum(torch.minimum(t1, t2), torch.minimum(t3, t4))
  tmax = torch.minimum(torch.maximum(t1, t2), torch.maximum(t3, t4))
  hit = (tmax >= tmin) & (tmax > 0.0)
  t = torch.where(tmin > 0.0, tmin, tmax)  # inside a rect -> exit face
  return torch.where(hit, t, float("inf"))


def _inside_any(px, py, rects):
  """[B, H, W] bool: points (px, py [B, H, W]) inside any of each scene's
  oriented rects [B, K, 6]; a loop over the K slots with a running
  ``any``."""
  inside = torch.zeros(px.shape, dtype=torch.bool, device=px.device)
  for k in range(rects.shape[1]):
    r = rects[:, k, :, None, None]                               # [B, 6, 1, 1]
    dx = px - r[:, 0]
    dy = py - r[:, 1]
    u = r[:, 4] * dx + r[:, 5] * dy
    v = -r[:, 5] * dx + r[:, 4] * dy
    inside |= (u.abs() <= r[:, 2]) & (v.abs() <= r[:, 3])
  return inside


def _actor_distance(ox, oy, dx, dy, state: SceneState, xy, alive, k: int,
                    boxes_of) -> torch.Tensor:
  """[B, W] distance along each column's ray to the nearest hit of the k
  nearest alive actors (``xy`` [B, N, 2], ``alive`` [B, N]); ``boxes_of``
  makes the selected actors' rects [B, k, 6] from their indices."""
  sel = bev._nearest_k(xy - state.hero_xy[:, None, :], alive, k)  # pylint: disable=protected-access
  t = _ray_rect_distance(ox, oy, dx, dy, boxes_of(sel))
  t = torch.where(take(alive, sel)[:, None, :], t, float("inf"))
  return t.min(dim=-1).values


def camera_classes(params: WorldParams, state: SceneState,
                   yaw_offset_deg: float) -> torch.Tensor:
  """[B, H, W] int32 class image of a camera looking at hero_yaw +
  ``yaw_offset_deg``."""
  device = state.hero_xy.device
  B = state.batch_size
  inf = float("inf")
  yaw = state.hero_yaw + float(np.deg2rad(np.float32(yaw_offset_deg)))
  cos_y, sin_y = torch.cos(yaw)[:, None], torch.sin(yaw)[:, None]
  ox, oy = state.hero_xy[:, 0], state.hero_xy[:, 1]

  # Each column's world-frame horizontal ray direction (its horizontal
  # component has unit length, so "t" is ground distance).
  u, norm_h, slope, t_ground = _ray_tables(device)
  dx = (cos_y - sin_y * u) / norm_h                              # [B, W]
  dy = (sin_y + cos_y * u) / norm_h

  # --- Building walls ----------------------------------------------------
  walls = bev.nearest_rects(params.map["wall_rects"], state.hero_xy,
                            MAX_CAMERA_WALLS)
  t_wall = _ray_rect_distance(ox, oy, dx, dy, walls).min(dim=-1).values

  # --- Vehicles and pedestrians (extruded oriented boxes) ------------------
  t_veh = t_ped = torch.full((B, IMAGE_W), inf, device=device)
  if state.num_npcs > 0:
    vehicle = params.vehicle

    def vehicle_boxes(sel):
      xy, yaw_sel = take(state.npc_xy, sel), take(state.npc_yaw, sel)
      return torch.stack([
          xy[..., 0], xy[..., 1], (vehicle.length / 2.0).expand(sel.shape),
          (vehicle.width / 2.0).expand(sel.shape), torch.cos(yaw_sel),
          torch.sin(yaw_sel)
      ], dim=-1)

    t_veh = _actor_distance(ox, oy, dx, dy, state, state.npc_xy,
                            state.npc_alive, MAX_CAMERA_VEHICLES,
                            vehicle_boxes)
  if state.num_pedestrians > 0:

    def ped_boxes(sel):
      xy = take(state.ped_xy, sel)
      half = torch.full(sel.shape, PED_HALF_SIZE, device=device)
      return torch.stack([xy[..., 0], xy[..., 1], half, half,
                          torch.ones_like(half), torch.zeros_like(half)],
                         dim=-1)

    t_ped = _actor_distance(ox, oy, dx, dy, state, state.ped_xy,
                            state.ped_alive, MAX_CAMERA_PEDS, ped_boxes)

  # --- Ground ---------------------------------------------------------------
  gx = ox[:, None, None] + dx[:, None, :] * t_ground             # [B, H, W]
  gy = oy[:, None, None] + dy[:, None, :] * t_ground
  roads = bev.nearest_rects(params.map["road_rects"], state.hero_xy,
                            MAX_CAMERA_ROADS)
  cls = torch.full(gx.shape, GROUND, dtype=torch.int32, device=device)
  cls.masked_fill_(_inside_any(gx, gy, roads), ROAD)
  del gx, gy

  # --- Depth resolve: the nearest surface, the first on ties ---------------
  best = torch.where(t_ground < FAR, t_ground, inf).expand(cls.shape)
  for t, height, code in ((t_wall, WALL_HEIGHT, BUILDING),
                          (t_veh, VEHICLE_HEIGHT, VEHICLE),
                          (t_ped, PED_HEIGHT, PED)):
    # A surface covers the pixel where its height at that distance spans
    # the ray's z.
    t = t[:, None, :]                                            # [B, 1, W]
    z = CAMERA_Z + slope * t
    t_eff = torch.where((t < FAR) & (z >= 0.0) & (z <= height), t, inf)
    cls.masked_fill_(t_eff < best, code)
    best = torch.minimum(best, t_eff)
  return cls.masked_fill_(~torch.isfinite(best), SKY)


def camera_rgb(params: WorldParams, state: SceneState,
               yaw_offset_deg: float = 0.0) -> torch.Tensor:
  """[B, 180, 320, 3] float32 RGB image."""
  cls = camera_classes(params, state, yaw_offset_deg)
  return _as_constant(_RGB, state.hero_xy.device)[cls.long()]
