"""Analytic event detection: collisions and lane invasions.

Port of the JAX package's ``sim/events.py`` over a scene batch: exact
geometric tests against the world state in place of CARLA's collision and
lane-invasion sensors.
"""

from typing import Tuple

import torch

from perfbench.reference.sim.types import SceneState, WorldParams
from perfbench.reference.sim.util import constant


def _obb_axes(yaw: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
  fwd = torch.stack([torch.cos(yaw), torch.sin(yaw)], dim=-1)
  right = torch.stack([-torch.sin(yaw), torch.cos(yaw)], dim=-1)
  return fwd, right


def obb_overlap(xy_a, yaw_a, half_a, xy_b, yaw_b, half_b) -> torch.Tensor:
  """Separating-axis test for oriented rectangles.

  All args broadcast; ``half_* = (half_length, half_width)``.
  Returns boolean overlap.
  """
  fa, ra = _obb_axes(yaw_a)
  fb, rb = _obb_axes(yaw_b)
  delta = xy_b - xy_a

  def project(axis):
    # Radius of each box projected on `axis` + center distance.
    r_a = (half_a[..., 0] * torch.abs(torch.sum(axis * fa, -1)) +
           half_a[..., 1] * torch.abs(torch.sum(axis * ra, -1)))
    r_b = (half_b[..., 0] * torch.abs(torch.sum(axis * fb, -1)) +
           half_b[..., 1] * torch.abs(torch.sum(axis * rb, -1)))
    dist = torch.abs(torch.sum(axis * delta, -1))
    return dist <= r_a + r_b

  return project(fa) & project(ra) & project(fb) & project(rb)


def hero_corners(params: WorldParams, xy: torch.Tensor,
                 yaw: torch.Tensor) -> torch.Tensor:
  """[B, 4, 2] world positions of the hero bounding-box corners."""
  hl = params.vehicle.length / 2.0
  hw = params.vehicle.width / 2.0
  fwd, right = _obb_axes(yaw)
  signs = constant(((1, 1), (1, -1), (-1, 1), (-1, -1)), xy.device)
  return (xy[:, None, :] + signs[None, :, 0:1] * hl * fwd[:, None, :] +
          signs[None, :, 1:2] * hw * right[:, None, :])


def detect_collision(params: WorldParams, state: SceneState,
                     new_xy: torch.Tensor, new_yaw: torch.Tensor,
                     new_speed: torch.Tensor) -> torch.Tensor:
  """[B] collision impulse intensity for each hero this step (0 when none).

  Checks: (a) OBB overlap with alive NPC vehicles, (b) pedestrian circles,
  (c) static obstacles (buildings) at the hero's corners.
  """
  from perfbench.reference import bev as bev_ops  # pylint: disable=import-outside-toplevel
  B = new_xy.shape[0]
  half_hero = torch.stack([params.vehicle.length / 2.0,
                           params.vehicle.width / 2.0])
  impulse = torch.zeros((B,), dtype=torch.float32, device=new_xy.device)

  if state.num_npcs > 0:
    K = state.num_npcs
    overlap = obb_overlap(new_xy[:, None, :], new_yaw[:, None],
                          half_hero[None, None, :], state.npc_xy,
                          state.npc_yaw, half_hero.expand(B, K, 2))
    overlap = overlap & state.npc_alive
    rel_speed = torch.abs(new_speed[:, None] - state.npc_speed) + \
        new_speed[:, None]
    impulse = torch.maximum(impulse, torch.amax(
        torch.where(overlap, 400.0 * (rel_speed + 1.0), 0.0), dim=-1))

  if state.num_pedestrians > 0:
    # Point-in-expanded-box (pedestrian radius 0.35 m).
    fwd, right = _obb_axes(new_yaw)
    rel = state.ped_xy - new_xy[:, None, :]
    du = torch.abs(rel[..., 0] * fwd[:, None, 0] + rel[..., 1] *
                   fwd[:, None, 1])
    dv = torch.abs(rel[..., 0] * right[:, None, 0] + rel[..., 1] *
                   right[:, None, 1])
    hit = ((du <= half_hero[0] + 0.35) & (dv <= half_hero[1] + 0.35) &
           state.ped_alive)
    impulse = torch.maximum(impulse, torch.amax(
        torch.where(hit, 400.0 * (new_speed[:, None] + 1.0), 0.0), dim=-1))

  # Static collision: a hero corner outside every nearby road corridor
  # (inflated by the sidewalk margin) has hit the buildings that line the
  # streets.
  corners = hero_corners(params, new_xy, new_yaw)             # [B, 4, 2]
  roads = bev_ops.nearest_rects(params.map["road_rects"], new_xy,
                                min(12, params.road_budget),
                                max_range=100.0)              # [B, k, 6]
  dx = corners[:, :, 0, None] - roads[:, None, :, 0]
  dy = corners[:, :, 1, None] - roads[:, None, :, 1]
  u = roads[:, None, :, 4] * dx + roads[:, None, :, 5] * dy
  v = -roads[:, None, :, 5] * dx + roads[:, None, :, 4] * dy
  sidewalk = 2.0  # maps/builder.py SIDEWALK
  inside = ((torch.abs(u) <= roads[:, None, :, 2] + sidewalk) &
            (torch.abs(v) <= roads[:, None, :, 3] + sidewalk))
  static_hit = torch.any(~torch.any(inside, dim=-1), dim=-1)
  return torch.maximum(
      impulse, torch.where(static_hit, 400.0 * (new_speed + 1.0), 0.0))


def lateral_lane_offset(params: WorldParams, xy: torch.Tensor,
                        wp: torch.Tensor) -> torch.Tensor:
  """Signed lateral offset of ``xy`` from the centerline at waypoint
  ``wp``."""
  wp_xy = params.map["wp_xy"][wp.long()]
  wp_yaw = params.map["wp_yaw"][wp.long()]
  rel = xy - wp_xy
  return -torch.sin(wp_yaw) * rel[..., 0] + torch.cos(wp_yaw) * rel[..., 1]


def detect_lane_invasion(params: WorldParams, state: SceneState,
                         new_xy: torch.Tensor,
                         new_wp: torch.Tensor) -> Tuple[torch.Tensor,
                                                        torch.Tensor]:
  """Lane-invasion *event* (fires on crossing, like CARLA's sensor).

  Returns:
    (count_this_step [B] i32, new_off_lane_flag [B] bool).
  """
  lat = torch.abs(lateral_lane_offset(params, new_xy, new_wp))
  in_junction = params.map["wp_is_junction"][new_wp.long()]
  outside = (lat > params.map["lane_width"] / 2.0 + 0.1) & ~in_junction
  fired = outside & ~state.off_lane_prev
  return fired.to(torch.int32), outside

