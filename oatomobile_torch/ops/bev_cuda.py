"""The BEV LIDAR splat as a hand-written CUDA kernel, its wrapper and its
plain PyTorch version.

Replaces the Pallas TPU kernel ``oatomobile_tpu/ops/bev_pallas.py::_kernel``
(launched by ``splat_lidar_batch`` there).  The kernel source is
``oatomobile_torch/csrc/bev_splat.cu``, its per-slot and per-pixel math
``csrc/bev_splat_tile.cuh``; the header comment of the ``.cu`` gives the
design, the rounding rules and the bound.  At the bench configuration
(1024 scenes) the splat must write 328 MB, 0.098 ms at the H100's
3.35 TB/s: it is bound by the bytes it writes.  The kernel culls slots per
8 x 40 pixel tile by a conservative pixel box, so a pixel is tested
against ~1 slot instead of every live one, and writes each pixel pair once
as one streaming 16-byte store.

The kernel is ``KERNEL`` (``native/nvcc.py``): built with ``nvcc`` at
first use, from the sources in the package, into the port's build
directory, as a shared library with a plain C entry point loaded through
``ctypes``.

``splat_lidar_batch`` dispatches on the device of its inputs: CPU tensors
go to the plain version ``splat_lidar_batch_reference``; CUDA tensors
launch the kernel or raise.  ``KERNEL.launches`` counts kernel launches.
``stress_inputs`` makes inputs that stress the kernel's culling.
"""

import ctypes
import functools
import math

import torch

from oatomobile_torch.native import nvcc
from oatomobile_torch.ops import bev

BEV = bev.BEV_SIZE  # 200
# Slot capacities of the kernel's shared memory (csrc/bev_splat.cu).
MAX_WALLS = bev.MAX_BEV_WALLS
MAX_ROADS = bev.MAX_BEV_ROADS
MAX_BOXES = bev.MAX_BEV_VEHICLES + bev.MAX_BEV_PEDESTRIANS
BLOCKS_PER_SCENE = 5  # bands of 40 rows (csrc/bev_splat.cu)
MAX_SCENES = (2**31 - 1) // BLOCKS_PER_SCENE  # the launch grid's x extent


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
  """Sets the C entry point's argument types on ``lib`` (the kernel's
  library, or another build of a splat source); returns it."""
  ptr, i32 = ctypes.c_void_p, ctypes.c_int
  lib.bev_splat_launch.argtypes = [ptr, ptr, i32, ptr, i32, ptr, i32, ptr,
                                   ptr, ptr, ptr, i32, ptr]
  lib.bev_splat_launch.restype = i32
  return lib


KERNEL = nvcc.Kernel("bev_splat", "bev_splat.cu",
                     (*nvcc.ARCH, *nvcc.SHARED, "-I", nvcc.CSRC), declare,
                     headers=("bev_splat_tile.cuh",))


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device):
  """(centers [200], counts [200, 200], ground [200, 200]) float32 on
  ``device``: the tables kernel and plain version share."""
  counts, ground = bev.const_images()
  return (bev.pixel_centers(device), torch.as_tensor(counts, device=device),
          torch.as_tensor(ground, device=device))


def _check_inputs(hero, walls, roads, boxes) -> None:
  device = hero.device
  B = hero.shape[0] if hero.dim() == 2 else -1
  nvcc.check_input("hero", hero, (None, 4), device, "hero")
  for name, x in (("walls", walls), ("roads", roads), ("boxes", boxes)):
    nvcc.check_input(name, x, (B, None, 6), device, "hero")
  if hero.shape[0] > MAX_SCENES:
    raise ValueError("at most {} scenes per launch, got {}".format(
        MAX_SCENES, hero.shape[0]))
  for name, x, cap in (("walls", walls, MAX_WALLS),
                       ("roads", roads, MAX_ROADS),
                       ("boxes", boxes, MAX_BOXES)):
    if x.shape[1] > cap:
      raise ValueError("{} has {} slots; the kernel holds at most {}".format(
          name, x.shape[1], cap))


def pixel_world(hero: torch.Tensor):
  """(wx, wy) [B, 200, 200]: every pixel centre of each scene in world
  coordinates, ``hx + cos*lx - sin*ly`` and ``hy + sin*lx + cos*ly``."""
  centers = bev.pixel_centers(hero.device)
  lx = centers[None, :, None]
  ly = centers[None, None, :]
  hx, hy = hero[:, 0, None, None], hero[:, 1, None, None]
  cos_y, sin_y = hero[:, 2, None, None], hero[:, 3, None, None]
  return hx + cos_y * lx - sin_y * ly, hy + sin_y * lx + cos_y * ly


def _rect_uv(rect: torch.Tensor, wx: torch.Tensor, wy: torch.Tensor):
  """(u, v, hl, hw) of the half-plane test of one slot per scene, rect
  [B, 6], against points wx, wy [B, ...]."""
  r = rect.reshape(rect.shape + (1,) * (wx.dim() - 1))
  cx, cy, hl, hw, cr, sr = r.unbind(1)
  cu = cr * cx + sr * cy
  cv = -sr * cx + cr * cy
  return cr * wx + sr * wy - cu, cr * wy - sr * wx - cv, hl, hw


def rect_inside(rect: torch.Tensor, wx: torch.Tensor,
                wy: torch.Tensor) -> torch.Tensor:
  """[B, ...] bool: the exact inside-test of one slot per scene, rect
  [B, 6] (cx, cy, hl, hw, cos, sin); empty slots (hl <= 0) hold nothing."""
  u, v, hl, hw = _rect_uv(rect, wx, wy)
  return (hl > 0.0) & (u.abs() <= hl) & (v.abs() <= hw)


def splat_lidar_batch_reference(hero: torch.Tensor, walls: torch.Tensor,
                                roads: torch.Tensor,
                                boxes: torch.Tensor) -> torch.Tensor:
  """The kernel's function in plain PyTorch, with the kernel's arithmetic
  (separate float32 multiplies and adds in the same association) on the
  kernel's exact inputs.  Loops over slots so memory stays O(B * 200^2).

  Returns:
    [B, 200, 200, 2] float32 (below, above).
  """
  _check_inputs(hero, walls, roads, boxes)
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


def splat_lidar_batch(hero: torch.Tensor, walls: torch.Tensor,
                      roads: torch.Tensor,
                      boxes: torch.Tensor) -> torch.Tensor:
  """Batched BEV splat from the kernel's inputs (see
  ``ops/bev.py::gather_inputs``).

  Args:
    hero: [B, 4] (x, y, cos_yaw, sin_yaw).
    walls: [B, NW <= 32, 6] oriented wall rects (cx, cy, hl, hw, cos, sin);
      empty slots have hl <= 0.
    roads: [B, NR <= 24, 6] road-corridor rects, already inflated by the
      sidewalk margin.
    boxes: [B, NV <= 40, 6] actor boxes, world frame.

  Returns:
    [B, 200, 200, 2] float32 (below, above).  On CUDA tensors the kernel
    computes it; on CPU tensors the plain version does.
  """
  if hero.device.type == "cpu":
    return splat_lidar_batch_reference(hero, walls, roads, boxes)
  if hero.device.type != "cuda":
    raise ValueError("splat_lidar_batch runs on CUDA or CPU tensors, got "
                     "{}".format(hero.device))
  _check_inputs(hero, walls, roads, boxes)
  nvcc.check_contiguous((("hero", hero), ("walls", walls), ("roads", roads),
                         ("boxes", boxes)))
  centers, counts, ground = _tables(hero.device)
  B = hero.shape[0]
  out = torch.empty((B, BEV, BEV, 2), dtype=torch.float32,
                    device=hero.device)
  stream = torch.cuda.current_stream(hero.device).cuda_stream
  err = KERNEL.library().bev_splat_launch(
      hero.data_ptr(), walls.data_ptr(), walls.shape[1], roads.data_ptr(),
      roads.shape[1], boxes.data_ptr(), boxes.shape[1], centers.data_ptr(),
      counts.data_ptr(), ground.data_ptr(), out.data_ptr(), B, stream)
  KERNEL.check(err)
  KERNEL.launches += 1
  return out


def stress_inputs(batch: int, seed: int, device) -> tuple:
  """Kernel inputs, made from ``seed`` on ``device``, that stress the
  culling: every one of the 32 + 24 + 40 slots live (in three scenes of
  four; the fourth also has empty and pushed-out slots), heroes anywhere in
  a town-sized square at any yaw or a multiple of 45 degrees, and six kinds
  of slot in turn:

    0. random rects around the hero;
    1. rects at 0, 45 and 90 degrees in the world frame;
    2. rects straddling an edge of the image;
    3. rects longer than the image, and in every scene one road rect
       larger than the image both ways;
    4. rects wholly off the image;
    5. rects with an edge exactly on a pixel centre (the pixel's |u|, by
       the kernel's arithmetic, is the half-length).

  Returns (hero [B, 4], walls [B, 32, 6], roads [B, 24, 6], boxes
  [B, 40, 6]), as ``splat_lidar_batch`` takes them.
  """
  device = torch.device(device)
  g = torch.Generator(device=device).manual_seed(seed)
  B, n = batch, MAX_WALLS + MAX_ROADS + MAX_BOXES

  def uniform(lo, hi, *shape):
    return lo + (hi - lo) * torch.rand(*shape, generator=g, device=device)

  def randint(high, *shape):
    return torch.randint(0, high, shape, generator=g, device=device)

  scene = torch.arange(B, device=device)
  yaw = torch.where(scene % 2 == 0, randint(8, B) * (math.pi / 4),
                    uniform(-math.pi, math.pi, B))
  hero = torch.stack([uniform(-500.0, 500.0, B), uniform(-500.0, 500.0, B),
                      torch.cos(yaw), torch.sin(yaw)], dim=-1)

  kind = (torch.arange(n, device=device) % 6)[None, :].expand(B, n)
  local = uniform(-60.0, 60.0, B, n, 2)
  half = uniform(0.2, 8.0, B, n, 2)
  angle = yaw[:, None] + uniform(-math.pi, math.pi, B, n)
  # 2: one coordinate on an image edge (bin edges at -50 and 51 m).
  edge = torch.where(randint(2, B, n) == 0, -50.0, 51.0)
  edge = edge + uniform(-2.0, 2.0, B, n)
  on_x = randint(2, B, n) == 0
  straddle = torch.stack([torch.where(on_x, edge, local[..., 0] * 0.75),
                          torch.where(on_x, local[..., 1] * 0.75, edge)], -1)
  local = torch.where((kind == 2)[..., None], straddle, local)
  # 3: longer than the image; road slot 0 larger both ways.
  strip = torch.stack([uniform(60.0, 400.0, B, n), half[..., 1]], -1)
  half = torch.where((kind == 3)[..., None], strip, half)
  half[:, MAX_WALLS] = uniform(60.0, 400.0, B, 2)
  # 4: wholly off: beyond the image's 72 m diagonal by more than the size.
  far = uniform(-math.pi, math.pi, B, n)
  dist = uniform(90.0, 300.0, B, n)
  off = torch.stack([dist * torch.cos(far), dist * torch.sin(far)], -1)
  local = torch.where((kind == 4)[..., None], off, local)
  # 5: centred within 3 m of a random pixel centre.
  centers = bev.pixel_centers(device)
  pix = randint(bev.BEV_SIZE, B, n, 2)
  near = centers[pix] + uniform(-3.0, 3.0, B, n, 2)
  local = torch.where((kind == 5)[..., None], near, local)

  cos_y, sin_y = hero[:, None, 2], hero[:, None, 3]
  cx = hero[:, None, 0] + cos_y * local[..., 0] - sin_y * local[..., 1]
  cy = hero[:, None, 1] + sin_y * local[..., 0] + cos_y * local[..., 1]
  cr, sr = torch.cos(angle), torch.sin(angle)
  # 1: world-frame axes at 0, 45 and 90 degrees, exactly as written.
  axes = torch.tensor([[1.0, 0.0], [0.70710677, 0.70710677], [0.0, 1.0]],
                      device=device)[randint(3, B, n)]
  cr = torch.where(kind == 1, axes[..., 0], cr)
  sr = torch.where(kind == 1, axes[..., 1], sr)
  rects = torch.stack([cx, cy, half[..., 0], half[..., 1], cr, sr], dim=-1)

  # 5: put pixel pix's centre exactly on the rect's u-edge.
  wx, wy = pixel_world(hero)
  flat = pix[..., 0] * bev.BEV_SIZE + pix[..., 1]
  px = wx.reshape(B, -1).gather(1, flat)
  py = wy.reshape(B, -1).gather(1, flat)
  u, v, _, hw = _rect_uv(rects.reshape(B * n, 6), px.reshape(-1, 1),
                         py.reshape(-1, 1))
  exact = torch.stack([rects[..., 0], rects[..., 1], u.abs().reshape(B, n),
                       torch.maximum(hw, v.abs()).reshape(B, n),
                       rects[..., 4], rects[..., 5]], dim=-1)
  rects = torch.where((kind == 5)[..., None], exact, rects)

  # Every fourth scene: empty (hl = 0 or < 0) and pushed-out slots.
  slot = torch.arange(n, device=device)[None, :]
  sparse = (scene % 4 == 3)[:, None]
  rects[..., 2] = torch.where(sparse & (slot % 7 == 1), -1.0, rects[..., 2])
  pushed = torch.tensor([-1e6, -1e6, 0.0, 0.0, 1.0, 0.0], device=device)
  rects = torch.where((sparse & (slot % 7 == 0))[..., None], pushed, rects)
  return (hero.contiguous(), rects[:, :MAX_WALLS].contiguous(),
          rects[:, MAX_WALLS:MAX_WALLS + MAX_ROADS].contiguous(),
          rects[:, MAX_WALLS + MAX_ROADS:].contiguous())
