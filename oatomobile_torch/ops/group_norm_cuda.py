"""The encoder's GroupNorm and its epilogue as one hand-written CUDA kernel,
its wrapper and its plain PyTorch version.

``models/perception``'s MobileNetV2 normalises with groups of 8 channels
and follows each GroupNorm with ReLU6, the residual add or nothing.  In
PyTorch that is four or five kernels a norm, each a pass over the tensor;
the kernel (``csrc/group_norm.cu``; its header gives the design, the
rounding rules and the bound: 12.2 GB a forward at 1024 scenes, 3.64 ms at
3.35 TB/s) reads each group once and writes it once.  It replaces no
Pallas kernel: the JAX package's GroupNorm is a flax layer that XLA fuses
with what follows.  Its result is PyTorch's on CUDA bit for bit
(``F.group_norm`` then ``F.relu6`` or ``x + h``): it repeats PyTorch's
order of summation and its fused multiply-adds.

``group_norm`` runs the plain version (``group_norm_reference``) on CPU
tensors and launches the kernel on CUDA tensors; on either it raises on
what the kernel does not take.  It is not differentiable: the encoder
takes it only where ``engages`` says so (float32 on CUDA, autograd off).
``KERNEL`` (``native/nvcc.py``) builds and loads the kernel and counts
its launches.
"""

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from oatomobile_torch.native import nvcc

GROUP = 8                   # channels a group (csrc/group_norm.cu kGroup)
EPILOGUES = {"none": 0, "relu6": 1, "residual": 2}


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
  """Sets the C entry points' argument types on ``lib`` (the kernel's
  library, or another build of its source); returns it."""
  ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                        ctypes.c_float)
  lib.group_norm_launch.argtypes = [
      ptr, ptr, ptr, ptr,          # x, gamma, beta, residual
      ptr, ptr, ptr,               # y, mean, rstd
      i64, i32, i32, f32, i32,     # rows, groups, hw, eps, epilogue
      ptr]                         # stream
  lib.group_norm_launch.restype = i32
  return lib


# IEEE float32: no fast-math, and no contraction beyond the fmaf calls that
# repeat PyTorch's.
KERNEL = nvcc.Kernel("group_norm", "group_norm.cu",
                     (*nvcc.ARCH, "-fmad=false", *nvcc.SHARED), declare)


def engages(x: torch.Tensor) -> bool:
  """Whether a GroupNorm of the encoder on ``x`` runs as the kernel: a
  float32 CUDA tensor with autograd off (no forward that may be
  differentiated, and no other precision, takes it).  The shape is not
  asked: ``group_norm`` raises on one the kernel does not take."""
  return (x.is_cuda and x.dtype == torch.float32 and
          not torch.is_grad_enabled())


def _check(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           relu6: bool, residual: Optional[torch.Tensor]) -> None:
  if x.dim() != 4:
    raise ValueError("x must be [N, C, H, W], got {}".format(tuple(x.shape)))
  channels = x.shape[1]
  if channels % GROUP != 0:
    raise ValueError("the kernel normalises groups of {} channels: C = {} is "
                     "not a multiple".format(GROUP, channels))
  if relu6 and residual is not None:
    raise ValueError("the kernel runs one epilogue: ReLU6 or the residual")
  named = [("x", x, tuple(x.shape)), ("weight", weight, (channels,)),
           ("bias", bias, (channels,))]
  if residual is not None:
    named.append(("residual", residual, tuple(x.shape)))
  for name, t, shape in named:
    nvcc.check_input(name, t, shape, x.device, "x")
    nvcc.check_contiguous(((name, t),))


def group_norm_reference(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, eps: float, *,
                         relu6: bool = False,
                         residual: Optional[torch.Tensor] = None):
  """The kernel's function in PyTorch's operations: ``F.group_norm`` with
  groups of 8 channels, then ``F.relu6`` or ``residual + y``."""
  y = F.group_norm(x, x.shape[1] // GROUP, weight, bias, eps)
  if relu6:
    y = F.relu6(y)
  return y if residual is None else residual + y


def launch(lib: ctypes.CDLL, x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor, eps: float, *, relu6: bool,
           residual: Optional[torch.Tensor], stream, stats: bool = False):
  """One call of ``lib``'s ``group_norm_launch`` on inputs that
  ``group_norm`` has checked, on ``stream``.  Returns y, or (y, mean,
  rstd) with ``stats`` (mean and rstd [N, C / 8], as
  ``torch.native_group_norm`` returns them: the checks of the kernel ask
  for them, the encoder does not)."""
  n, channels, h, w = x.shape
  y = torch.empty_like(x)
  mean = rstd = None
  if stats:
    mean, rstd = (torch.empty((n, channels // GROUP), dtype=torch.float32,
                              device=x.device) for _ in range(2))
  epilogue = ("relu6" if relu6 else
              "none" if residual is None else "residual")

  def address(t):
    return None if t is None else t.data_ptr()

  err = lib.group_norm_launch(
      x.data_ptr(), weight.data_ptr(), bias.data_ptr(), address(residual),
      y.data_ptr(), address(mean), address(rstd), n * channels // GROUP,
      channels // GROUP, h * w, eps, EPILOGUES[epilogue], stream)
  KERNEL.check(err)
  return (y, mean, rstd) if stats else y


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float, *, relu6: bool = False,
               residual: Optional[torch.Tensor] = None) -> torch.Tensor:
  """GroupNorm of x [N, C, H, W] with groups of 8 channels (``weight`` and
  ``bias`` [C]), then ReLU6 (``relu6``) or ``residual + y``.

  Every tensor float32, contiguous, on one device; C a multiple of 8;
  one epilogue at most.  On CUDA tensors the kernel computes it, on CPU
  tensors the plain version does.
  """
  _check(x, weight, bias, relu6, residual)
  if x.device.type == "cpu":
    return group_norm_reference(x, weight, bias, eps, relu6=relu6,
                                residual=residual)
  if x.device.type != "cuda":
    raise ValueError("the GroupNorm kernel runs on CUDA or CPU tensors, got "
                     "{}".format(x.device))
  if x.numel() == 0:
    return torch.empty_like(x)
  y = launch(KERNEL.library(), x, weight, bias, eps, relu6=relu6,
             residual=residual,
             stream=torch.cuda.current_stream(x.device).cuda_stream)
  KERNEL.launches += 1
  return y
