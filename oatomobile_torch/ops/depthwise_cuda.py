"""The encoder's depthwise 3x3 convolutions as one hand-written CUDA kernel,
its wrapper and its plain PyTorch version.

``models/perception``'s MobileNetV2 has 17 depthwise 3x3 convolutions
(stride 1 or 2, no bias) with flax's ``"SAME"`` padding.  In PyTorch each
is ATen's ``conv_depthwise2d_forward``, after an ``F.pad`` copy of the
input where the padding is uneven; the kernel (``csrc/depthwise_conv.cu``;
its header gives the design, the rounding rule and the bound: 5.40 GB a
forward at 1024 scenes, 1.61 ms at 3.35 TB/s) reads the unpadded input
once and leaves out the taps that fall outside it.  It replaces no Pallas
kernel: the JAX package's depthwise layers are flax convolutions.  Its
result is PyTorch's on CUDA (``F.pad`` where uneven, then ``F.conv2d``)
bit for bit: it repeats ATen's order of the nine taps and its fused
multiply-adds.

``depthwise`` runs the plain version (``depthwise_reference``: ATen's tap
order in tensor operations, each multiply-add rounded once) on CPU
tensors and launches the kernel on CUDA tensors; on either it raises on
what the kernel does not take.  It is not differentiable: the encoder
takes it only where ``engages`` says so (float32 on CUDA, autograd off).
``KERNEL`` (``native/nvcc.py``) builds and loads the kernel and counts
its launches.
"""

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from oatomobile_torch.native import nvcc

KERNEL_SIZE = 3
STRIDES = (1, 2)
MAX_PAD = 2
# The widest input row the kernel takes (csrc/depthwise_conv.cu kMaxWidth).
MAX_WIDTH = 1365

Padding = Tuple[int, int, int, int]  # (top, bottom, left, right)


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
  """Sets the C entry point's argument types on ``lib`` (the kernel's
  library, or another build of its source); returns it."""
  ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
  lib.depthwise_conv_launch.argtypes = [
      ptr, ptr, ptr,               # x, weight, y
      i64, i32, i32, i32,          # planes, channels, h, w
      i32, i32, i32, i32, i32,     # ho, wo, stride, top, left
      ptr]                         # stream
  lib.depthwise_conv_launch.restype = i32
  return lib


# IEEE float32: no fast-math, and no contraction beyond the fmaf that
# repeats ATen's.
KERNEL = nvcc.Kernel("depthwise_conv", "depthwise_conv.cu",
                     (*nvcc.ARCH, "-fmad=false", *nvcc.SHARED), declare)


def engages(x: torch.Tensor) -> bool:
  """Whether a depthwise convolution of the encoder on ``x`` runs as the
  kernel: a float32 CUDA tensor with autograd off (no forward that may be
  differentiated, and no other precision, takes it).  The shape is not
  asked: ``depthwise`` raises on one the kernel does not take."""
  return (x.is_cuda and x.dtype == torch.float32 and
          not torch.is_grad_enabled())


def output_size(size: int, stride: int, low: int, high: int) -> int:
  """The output extent of a 3-tap convolution along one dim."""
  return (size + low + high - KERNEL_SIZE) // stride + 1


def output_shape(x: torch.Tensor, stride: int,
                 padding: Padding) -> Tuple[int, int, int, int]:
  """[N, C, Ho, Wo] of the convolution of x."""
  top, bottom, left, right = padding
  n, c, h, w = x.shape
  return (n, c, output_size(h, stride, top, bottom),
          output_size(w, stride, left, right))


def _check(x: torch.Tensor, weight: torch.Tensor, stride: int,
           padding: Padding) -> None:
  if x.dim() != 4:
    raise ValueError("x must be [N, C, H, W], got {}".format(tuple(x.shape)))
  channels = x.shape[1]
  if weight.dim() == 4 and tuple(weight.shape[2:]) != (KERNEL_SIZE,
                                                        KERNEL_SIZE):
    raise ValueError("the kernel convolves {0} x {0} taps, got {1}".format(
        KERNEL_SIZE, tuple(weight.shape[2:])))
  if stride not in STRIDES:
    raise ValueError("the kernel takes stride 1 or 2, got {}".format(stride))
  if len(padding) != 4 or not all(0 <= p <= MAX_PAD for p in padding):
    raise ValueError("padding must be (top, bottom, left, right), each 0 to "
                     "{}, got {}".format(MAX_PAD, padding))
  top, bottom, left, right = padding
  if (output_size(x.shape[2], stride, top, bottom) < 1 or
      output_size(x.shape[3], stride, left, right) < 1):
    raise ValueError("a {} x {} input with padding {} has no output".format(
        x.shape[2], x.shape[3], padding))
  if x.shape[3] > MAX_WIDTH:
    raise ValueError("the kernel takes rows of at most {} floats, got "
                     "{}".format(MAX_WIDTH, x.shape[3]))
  for name, t, shape in (("x", x, tuple(x.shape)),
                         ("weight", weight,
                          (channels, 1, KERNEL_SIZE, KERNEL_SIZE))):
    nvcc.check_input(name, t, shape, x.device, "x")
    nvcc.check_contiguous(((name, t),))


def depthwise_reference(x: torch.Tensor, weight: torch.Tensor, stride: int,
                        padding: Padding) -> torch.Tensor:
  """The kernel's function in tensor operations, in ATen's order: each
  output starts at 0 and adds weight * input, rounded once, for the taps
  (kh outer, kw inner) that fall inside x."""
  top, _, left, _ = padding
  n, c, h, w = x.shape
  _, _, ho, wo = output_shape(x, stride, padding)
  # Tap (kh, kw) of output (oh, ow) is xp[oh * stride + kh, ow * stride +
  # kw]; its zeros are masked out, not added.
  xp = F.pad(x, (left, MAX_PAD, top, MAX_PAD))
  rows = torch.arange(ho, device=x.device) * stride - top
  cols = torch.arange(wo, device=x.device) * stride - left
  acc = torch.zeros((n, c, ho, wo), dtype=torch.float32, device=x.device)
  for kh in range(KERNEL_SIZE):
    row_in = (rows + kh >= 0) & (rows + kh < h)
    for kw in range(KERNEL_SIZE):
      inside = row_in[:, None] & ((cols + kw >= 0) & (cols + kw < w))[None]
      tap = xp[:, :, kh:kh + (ho - 1) * stride + 1:stride,
               kw:kw + (wo - 1) * stride + 1:stride]
      acc = torch.where(inside,
                        nvcc.fmaf(weight[:, :, kh, kw].view(1, c, 1, 1), tap,
                                  acc), acc)
  return acc


def launch(lib: ctypes.CDLL, x: torch.Tensor, weight: torch.Tensor,
           stride: int, padding: Padding, stream) -> torch.Tensor:
  """One call of ``lib``'s ``depthwise_conv_launch`` on inputs that
  ``depthwise`` has checked, on ``stream``; returns y."""
  n, c, h, w = x.shape
  top, _, left, _ = padding
  y = torch.empty(output_shape(x, stride, padding), dtype=torch.float32,
                  device=x.device)
  err = lib.depthwise_conv_launch(x.data_ptr(), weight.data_ptr(),
                                  y.data_ptr(), n * c, c, h, w, y.shape[2],
                                  y.shape[3], stride, top, left, stream)
  KERNEL.check(err)
  return y


def depthwise(x: torch.Tensor, weight: torch.Tensor, stride: int,
              padding: Padding) -> torch.Tensor:
  """The depthwise 3x3 convolution of x [N, C, H, W] by weight [C, 1, 3,
  3], no bias, with ``stride`` (1 or 2) and ``padding`` (top, bottom,
  left, right; each 0 to 2) of zeros around x.

  Both float32 and contiguous, on one device; rows of at most MAX_WIDTH
  floats.  On CUDA tensors the kernel computes it, on CPU tensors the
  plain version does.
  """
  _check(x, weight, stride, padding)
  if x.device.type == "cpu":
    return depthwise_reference(x, weight, stride, padding)
  if x.device.type != "cuda":
    raise ValueError("the depthwise kernel runs on CUDA or CPU tensors, got "
                     "{}".format(x.device))
  if x.numel() == 0:
    return x.new_empty(output_shape(x, stride, padding))
  y = launch(KERNEL.library(), x, weight, stride, padding,
             torch.cuda.current_stream(x.device).cuda_stream)
  KERNEL.launches += 1
  return y
