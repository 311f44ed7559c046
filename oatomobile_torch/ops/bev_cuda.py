"""The BEV LIDAR splat as a hand-written CUDA kernel, its wrapper and its
plain PyTorch version.

Replaces the Pallas TPU kernel ``oatomobile_tpu/ops/bev_pallas.py::_kernel``
(launched by ``splat_lidar_batch`` there).  The kernel source is
``oatomobile_torch/csrc/bev_splat.cu``; its header comment gives the
design, the rounding rules and the bound.  At the bench configuration
(1024 scenes) the splat must write 328 MB (0.098 ms at the H100's
3.35 TB/s) and test 40,000 pixels against ~15.5 live slots per scene at
~10 FP32 operations a test (0.095 ms at 67 TFLOP/s; 0.26 ms if all 42
slots were live), so it is bound by the bytes it writes.  The kernel
writes each pixel once in the final interleaved layout, keeps every
pixel-slot test in registers and drops empty slots before its loop.

The kernel is built with ``nvcc`` at first use, from the source in the
package, into the port's build directory, as a shared library with a
plain C entry point loaded through ``ctypes``.

``splat_lidar_batch`` dispatches on the device of its inputs: CPU tensors
go to the plain version ``splat_lidar_batch_reference``; CUDA tensors
launch the kernel or raise.  ``launches`` counts kernel launches.
"""

import ctypes
import functools
import os
import shutil
import subprocess
import tempfile
import time

import torch

from oatomobile_torch import paths
from oatomobile_torch.ops import bev

BEV = bev.BEV_SIZE  # 200
# Slot capacities of the kernel's shared memory (csrc/bev_splat.cu).
MAX_WALLS = bev.MAX_BEV_WALLS
MAX_ROADS = bev.MAX_BEV_ROADS
MAX_BOXES = bev.MAX_BEV_VEHICLES + bev.MAX_BEV_PEDESTRIANS
MAX_SCENES = 65535  # the launch grid's y extent

SOURCE = os.path.join(paths.PACKAGE_DIR, "csrc", "bev_splat.cu")
LIBRARY = os.path.join(paths.BUILD_DIR, "kernels", "libbev_splat.so")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Kernel launches since import (or since the caller last reset it).
launches = 0
# What the last build printed (nvcc -Xptxas -v: registers, shared memory)
# and how long it took, for the record.
build_log = ""
build_seconds = 0.0


def _nvcc() -> str:
  found = shutil.which("nvcc")
  if found:
    return found
  default = "/usr/local/cuda/bin/nvcc"
  if os.path.exists(default):
    return default
  raise RuntimeError("nvcc not found: the BEV splat kernel is built from "
                     "{} at first use and needs the CUDA toolkit".format(
                         SOURCE))


def build() -> str:
  """Compiles the kernel into ``LIBRARY`` unless it is newer than its
  source; returns the library path."""
  global build_log, build_seconds
  if (os.path.exists(LIBRARY) and
      os.path.getmtime(LIBRARY) >= os.path.getmtime(SOURCE)):
    return LIBRARY
  os.makedirs(os.path.dirname(LIBRARY), exist_ok=True)
  fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(LIBRARY))
  os.close(fd)
  cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE]
  t0 = time.perf_counter()
  proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
  build_seconds = time.perf_counter() - t0
  build_log = proc.stdout + proc.stderr
  if proc.returncode != 0:
    os.unlink(tmp)
    raise RuntimeError("nvcc failed ({}):\n{}".format(" ".join(cmd),
                                                     build_log))
  os.replace(tmp, LIBRARY)
  return LIBRARY


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
  lib = ctypes.CDLL(build())
  ptr, i32 = ctypes.c_void_p, ctypes.c_int
  lib.bev_splat_launch.argtypes = [ptr, ptr, i32, ptr, i32, ptr, i32, ptr,
                                   ptr, ptr, ptr, i32, ptr]
  lib.bev_splat_launch.restype = i32
  return lib


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device):
  """(centers [200], counts [200, 200], ground [200, 200]) float32 on
  ``device``: the tables kernel and plain version share."""
  counts, ground = bev.const_images()
  return (bev.pixel_centers(device), torch.as_tensor(counts, device=device),
          torch.as_tensor(ground, device=device))


def _check(name: str, x: torch.Tensor, shape, device) -> None:
  if x.dtype != torch.float32:
    raise TypeError("{} must be float32, got {}".format(name, x.dtype))
  if x.device != device:
    raise ValueError("{} is on {}, hero on {}".format(name, x.device, device))
  if x.dim() != len(shape) or any(
      want is not None and got != want for got, want in zip(x.shape, shape)):
    raise ValueError("{} must have shape {}, got {}".format(
        name, tuple("*" if s is None else s for s in shape), tuple(x.shape)))


def _check_inputs(hero, walls, roads, boxes) -> None:
  device = hero.device
  B = hero.shape[0] if hero.dim() == 2 else -1
  _check("hero", hero, (None, 4), device)
  _check("walls", walls, (B, None, 6), device)
  _check("roads", roads, (B, None, 6), device)
  _check("boxes", boxes, (B, None, 6), device)
  if hero.shape[0] > MAX_SCENES:
    raise ValueError("at most {} scenes per launch, got {}".format(
        MAX_SCENES, hero.shape[0]))
  for name, x, cap in (("walls", walls, MAX_WALLS),
                       ("roads", roads, MAX_ROADS),
                       ("boxes", boxes, MAX_BOXES)):
    if x.shape[1] > cap:
      raise ValueError("{} has {} slots; the kernel holds at most {}".format(
          name, x.shape[1], cap))


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
  centers, counts, ground = _tables(hero.device)
  lx = centers[None, :, None]
  ly = centers[None, None, :]
  hx, hy = hero[:, 0, None, None], hero[:, 1, None, None]
  cos_y, sin_y = hero[:, 2, None, None], hero[:, 3, None, None]
  wx = hx + cos_y * lx - sin_y * ly
  wy = hy + sin_y * lx + cos_y * ly

  def any_inside(rects: torch.Tensor) -> torch.Tensor:
    hit = torch.zeros(wx.shape, dtype=torch.bool, device=wx.device)
    for k in range(rects.shape[1]):
      r = rects[:, k, :, None, None]
      cx, cy, hl, hw, cr, sr = r.unbind(1)
      cu = cr * cx + sr * cy
      cv = -sr * cx + cr * cy
      u = cr * wx + sr * wy - cu
      v = cr * wy - sr * wx - cv
      hit |= (hl > 0.0) & (u.abs() <= hl) & (v.abs() <= hw)
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
  global launches
  if hero.device.type == "cpu":
    return splat_lidar_batch_reference(hero, walls, roads, boxes)
  if hero.device.type != "cuda":
    raise ValueError("splat_lidar_batch runs on CUDA or CPU tensors, got "
                     "{}".format(hero.device))
  _check_inputs(hero, walls, roads, boxes)
  for name, x in (("hero", hero), ("walls", walls), ("roads", roads),
                  ("boxes", boxes)):
    if not x.is_contiguous():
      raise ValueError("{} must be contiguous".format(name))
  lib = _library()
  centers, counts, ground = _tables(hero.device)
  B = hero.shape[0]
  out = torch.empty((B, BEV, BEV, 2), dtype=torch.float32,
                    device=hero.device)
  stream = torch.cuda.current_stream(hero.device).cuda_stream
  err = lib.bev_splat_launch(
      hero.data_ptr(), walls.data_ptr(), walls.shape[1], roads.data_ptr(),
      roads.shape[1], boxes.data_ptr(), boxes.shape[1], centers.data_ptr(),
      counts.data_ptr(), ground.data_ptr(), out.data_ptr(), B, stream)
  if err != 0:
    raise RuntimeError("bev_splat kernel launch failed: CUDA error "
                       "{}".format(err))
  launches += 1
  return out
