"""TransFuser's fusion upsample-and-add as one hand-written CUDA kernel, its
wrapper and its plain PyTorch version.

Each of ``models/transfuser``'s four fusions upsamples its GPT's two 8 x 8
anchor maps bilinearly to the camera and BEV trunks' maps (8 x scale
pixels a side) and adds them to the trunks.  In PyTorch that is two
``F.interpolate`` calls (ATen's ``upsample_bilinear2d_out_frame``) and two
adds; the kernel (``csrc/fusion_upsample.cu``; its header gives the
design, the rounding rule and the bound: 2.14 GB a TransFuser step at 256
scenes, 0.64 ms at 3.35 TB/s) does both trunks of a fusion in one launch,
reading each trunk once and writing each sum once.  It replaces no Pallas
kernel: the JAX package has no TransFuser.  Its result is PyTorch's
``trunk + F.interpolate(anchors, scale_factor=scale, mode="bilinear",
align_corners=False)`` on CUDA bit for bit: it repeats ATen's source
indices, weights, order and fused multiply-adds.

``upsample_add`` runs the plain version (``upsample_add_reference``: the
kernel's arithmetic in tensor operations, each fused multiply-add rounded
once) on CPU tensors and launches the kernel on CUDA tensors; on either it
raises on what the kernel does not take.  It is not differentiable: the
model takes it only where ``engages`` says so (float32 on CUDA, autograd
off).  ``KERNEL`` (``native/nvcc.py``) builds and loads the kernel and
counts its launches.
"""

import ctypes
from typing import Tuple

import torch

from oatomobile_torch.native import nvcc

ANCHORS = 8          # the anchor maps' side
# The largest scale the kernel takes (csrc/fusion_upsample.cu kMaxScale):
# maps of up to 1,024 pixels a side.
MAX_SCALE = 128


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
  """Sets the C entry point's argument types on ``lib`` (the kernel's
  library, or another build of its source); returns it."""
  ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
  lib.fusion_upsample_launch.argtypes = [
      ptr, ptr, ptr,               # trunk, anchors, out of the first trunk
      ptr, ptr, ptr,               # the same of the second
      i64, i32,                    # planes (N * C), scale
      ptr]                         # stream
  lib.fusion_upsample_launch.restype = i32
  return lib


# IEEE float32: no fast-math, and no contraction beyond the fmaf that
# repeats ATen's.
KERNEL = nvcc.Kernel("fusion_upsample", "fusion_upsample.cu",
                     (*nvcc.ARCH, "-fmad=false", *nvcc.SHARED), declare)


def engages(x: torch.Tensor) -> bool:
  """Whether a fusion's upsample-and-add on the trunk map ``x`` runs as the
  kernel: a float32 CUDA tensor with autograd off (no forward that may be
  differentiated, and no other precision, takes it).  The shape is not
  asked: ``upsample_add`` raises on one the kernel does not take."""
  return (x.is_cuda and x.dtype == torch.float32 and
          not torch.is_grad_enabled())


def _check(trunks, anchors, scale) -> None:
  if isinstance(scale, bool) or not isinstance(scale, int):
    raise TypeError("scale must be an int, got {!r}".format(scale))
  if not 1 <= scale <= MAX_SCALE:
    raise ValueError("the kernel takes scales 1 to {}, got {}".format(
        MAX_SCALE, scale))
  if len(trunks) != 2 or len(anchors) != 2:
    raise ValueError("the kernel takes two trunks and their two anchor maps")
  if trunks[0].dim() != 4:
    raise ValueError("a trunk must be [N, C, H, W], got {}".format(
        tuple(trunks[0].shape)))
  n, c = trunks[0].shape[:2]
  side = ANCHORS * scale
  device = trunks[0].device
  for i in (0, 1):
    for name, x, shape in (("trunk", trunks[i], (n, c, side, side)),
                           ("anchors", anchors[i], (n, c, ANCHORS, ANCHORS))):
      name = "{} {}".format(name, i)
      nvcc.check_input(name, x, shape, device, "trunk 0")
      nvcc.check_contiguous(((name, x),))
      if device.type == "cuda" and x.data_ptr() % 16:
        raise ValueError("{} must start at a 16-byte-aligned address".format(
            name))


def _sum_of_products(p: torch.Tensor, x: torch.Tensor, q: torch.Tensor,
                     y: torch.Tensor) -> torch.Tensor:
  """p * x + q * y as the kernel rounds it: fmaf(p, x, q * y)."""
  return nvcc.fmaf(p, x, q * y)


def _source(scale: int, size: int, device):
  """ATen's source index of each of ``size`` outputs along one dim, as the
  kernel computes it: (index, step to the next, lambda of the index, lambda
  of the next), the lambdas float32."""
  rscale = torch.tensor(1.0 / scale, dtype=torch.float64).float()
  dst = torch.arange(size, device=device, dtype=torch.float32) + 0.5
  src = nvcc.fmaf(rscale.to(device).expand(size), dst,
                  torch.full((size,), -0.5, device=device))
  src = torch.clamp_min(src, 0.0)
  index = src.to(torch.int64)   # truncation: src >= 0
  step = (index < ANCHORS - 1).to(torch.int64)
  lambda1 = src - index.to(torch.float32)
  return index, step, 1.0 - lambda1, lambda1


def upsample_add_reference(trunk: torch.Tensor, anchors: torch.Tensor,
                           scale: int) -> torch.Tensor:
  """The kernel's function for one trunk in tensor operations: trunk [N, C,
  8 * scale, 8 * scale] plus anchors [N, C, 8, 8] upsampled bilinearly in
  ATen's order and rounding (a copy at scale 1)."""
  if scale == 1:
    return trunk + anchors
  side = ANCHORS * scale
  h1, hp, h0lambda, h1lambda = _source(scale, side, trunk.device)
  h0lambda, h1lambda = h0lambda.view(-1, 1), h1lambda.view(-1, 1)
  w1, wp, w0lambda, w1lambda = _source(scale, side, trunk.device)

  def at(rows, cols):
    return anchors[:, :, rows][:, :, :, cols]   # [N, C, side, side]

  upper = _sum_of_products(w0lambda, at(h1, w1), w1lambda, at(h1, w1 + wp))
  lower = _sum_of_products(w0lambda, at(h1 + hp, w1), w1lambda,
                           at(h1 + hp, w1 + wp))
  return trunk + _sum_of_products(h0lambda, upper, h1lambda, lower)


def launch(lib: ctypes.CDLL, trunks, anchors, scale: int,
           stream) -> Tuple[torch.Tensor, torch.Tensor]:
  """One call of ``lib``'s ``fusion_upsample_launch`` on inputs that
  ``upsample_add`` has checked, on ``stream``; returns the two sums."""
  outs = tuple(torch.empty_like(t) for t in trunks)
  n, c = trunks[0].shape[:2]
  err = lib.fusion_upsample_launch(
      trunks[0].data_ptr(), anchors[0].data_ptr(), outs[0].data_ptr(),
      trunks[1].data_ptr(), anchors[1].data_ptr(), outs[1].data_ptr(),
      n * c, scale, stream)
  KERNEL.check(err)
  return outs


def upsample_add(trunks: Tuple[torch.Tensor, torch.Tensor],
                 anchors: Tuple[torch.Tensor, torch.Tensor],
                 scale: int) -> Tuple[torch.Tensor, torch.Tensor]:
  """``trunks[i] + F.interpolate(anchors[i], scale_factor=scale,
  mode="bilinear", align_corners=False)`` for both i, as new tensors.

  Trunks [N, C, 8 * scale, 8 * scale] and anchors [N, C, 8, 8], all
  float32 and contiguous on one device; ``scale`` an int from 1 to
  MAX_SCALE.  On CUDA tensors (16-byte aligned) one launch of the kernel
  computes both, on CPU tensors the plain version does.
  """
  _check(trunks, anchors, scale)
  device = trunks[0].device
  if device.type == "cpu":
    return tuple(upsample_add_reference(t, a, scale)
                 for t, a in zip(trunks, anchors))
  if device.type != "cuda":
    raise ValueError("the fusion upsample kernel runs on CUDA or CPU "
                     "tensors, got {}".format(device))
  outs = launch(KERNEL.library(), trunks, anchors, scale,
                torch.cuda.current_stream(device).cuda_stream)
  KERNEL.launches += 1
  return outs
