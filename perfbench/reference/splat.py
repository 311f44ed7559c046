"""The BEV LIDAR splat of the reference: the kernel's function in plain
PyTorch on the kernel's inputs (``bev.gather_inputs``), on any device.

A frozen copy of the program's plain splat: separate float32 multiplies
and adds in the kernel's association, one slot at a time, so that memory
stays O(B * 200^2).
"""

import functools

import torch

from perfbench.reference import bev


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device):
  """(centers [200], counts [200, 200], ground [200, 200]) float32."""
  counts, ground = bev.const_images()
  return (bev.pixel_centers(device), torch.as_tensor(counts, device=device),
          torch.as_tensor(ground, device=device))


def pixel_world(hero: torch.Tensor):
  """(wx, wy) [B, 200, 200]: every pixel centre of each scene in world
  coordinates, ``hx + cos*lx - sin*ly`` and ``hy + sin*lx + cos*ly``."""
  centers = bev.pixel_centers(hero.device)
  lx = centers[None, :, None]
  ly = centers[None, None, :]
  hx, hy = hero[:, 0, None, None], hero[:, 1, None, None]
  cos_y, sin_y = hero[:, 2, None, None], hero[:, 3, None, None]
  return hx + cos_y * lx - sin_y * ly, hy + sin_y * lx + cos_y * ly


def rect_inside(rect: torch.Tensor, wx: torch.Tensor,
                wy: torch.Tensor) -> torch.Tensor:
  """[B, ...] bool: the inside-test of one slot per scene, rect [B, 6]
  (cx, cy, hl, hw, cos, sin); empty slots (hl <= 0) hold nothing."""
  r = rect.reshape(rect.shape + (1,) * (wx.dim() - 1))
  cx, cy, hl, hw, cr, sr = r.unbind(1)
  cu = cr * cx + sr * cy
  cv = -sr * cx + cr * cy
  u = cr * wx + sr * wy - cu
  v = cr * wy - sr * wx - cv
  return (hl > 0.0) & (u.abs() <= hl) & (v.abs() <= hw)


def splat_lidar_batch(hero: torch.Tensor, walls: torch.Tensor,
                      roads: torch.Tensor,
                      boxes: torch.Tensor) -> torch.Tensor:
  """[B, 200, 200, 2] float32 (below, above) from hero [B, 4], walls,
  roads and boxes [B, N, 6]."""
  _, counts, ground = _tables(hero.device)
  wx, wy = pixel_world(hero)

  def any_inside(rects: torch.Tensor) -> torch.Tensor:
    hit = torch.zeros(wx.shape, dtype=torch.bool, device=wx.device)
    for k in range(rects.shape[1]):
      hit |= rect_inside(rects[:, k], wx, wy)
    return hit

  occupied = any_inside(walls) | any_inside(boxes)
  is_open = any_inside(roads)
  below = torch.where(is_open & ~occupied, ground, 0.0)
  above = torch.where(occupied, counts, 0.0)
  return torch.stack([below, above], dim=-1)
