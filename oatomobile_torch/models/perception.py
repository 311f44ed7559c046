"""MobileNetV2 feature extractor: port of the JAX package's
``models/perception.py``, in NCHW.

As in the JAX package: GroupNorm with groups of 8 channels (epsilon
1e-6, flax's default, not torch's 1e-5), ReLU6, a global mean pool and a
``num_classes`` head.  flax's ``padding="SAME"`` depends on the input
size: a 3x3 stride-2 conv pads ``total = max((out - 1) * 2 + 3 - in, 0)``
with ``total // 2`` on the low side and the rest on the high side, so
100 -> 50 and 50 -> 25 pad (0, 1) and 25 -> 13, 13 -> 7, 7 -> 4 pad
(1, 1).  ``_SameConv`` works the padding out from each input.

flax's GroupNorm takes the variance as E[x^2] - E[x]^2 (clipped at 0);
``F.group_norm`` takes it in two passes.  The two agree to float32
rounding (the tests state the tolerance).

Each GroupNorm and what follows it (ReLU6, the residual add or nothing)
runs as one launch of ``ops/group_norm_cuda``'s kernel, and each
depthwise convolution with its padding as one launch of
``ops/depthwise_cuda``'s, where that can show nothing but speed: on a
float32 CUDA tensor with autograd off (the policies' and agents'
encoders), at any input size, equal to PyTorch's operations bit for bit.
Every other forward (training, the bfloat16 copy, the CPU) runs
``F.group_norm``, ``F.relu6`` and ``+``, and ``F.pad`` (where uneven) and
``F.conv2d``.
"""

import functools
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from oatomobile_torch import device as device_lib
from oatomobile_torch.models import initializers
from oatomobile_torch.ops import depthwise_cuda, group_norm_cuda

# (expansion t, channels c, repeats n, stride s) of the JAX package.
_INVERTED_RESIDUAL_SETTINGS: Sequence[Tuple[int, int, int, int]] = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)

GROUP_SIZE = 8
GROUP_NORM_EPS = 1e-6  # flax.linen.GroupNorm's default epsilon


def _norm(channels: int) -> nn.GroupNorm:
  return nn.GroupNorm(channels // GROUP_SIZE, channels, eps=GROUP_NORM_EPS,
                      device="meta")


def _normalise(norm: nn.GroupNorm, h: torch.Tensor, *, relu6: bool = False,
               residual: Optional[torch.Tensor] = None) -> torch.Tensor:
  """``norm(h)``, then ``F.relu6`` or ``residual + ...``: one kernel launch
  where ``group_norm_cuda.engages(h)``, else PyTorch's operations."""
  if group_norm_cuda.engages(h):
    return group_norm_cuda.group_norm(h, norm.weight, norm.bias, norm.eps,
                                      relu6=relu6, residual=residual)
  h = norm(h)
  if relu6:
    h = F.relu6(h)
  return h if residual is None else residual + h


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
  """(low, high) padding of flax's ``"SAME"`` along one spatial dim."""
  out = -(-size // stride)
  total = max((out - 1) * stride + kernel - size, 0)
  return total // 2, total - total // 2


def same_conv(x: torch.Tensor, weight: torch.Tensor, stride,
              padding: Tuple[int, int, int, int],
              groups: int = 1) -> torch.Tensor:
  """Bias-free ``F.conv2d`` of x with ``padding`` (top, bottom, left,
  right): symmetric padding goes to the convolution, uneven padding to an
  explicit ``F.pad``."""
  top, bottom, left, right = padding
  if top == bottom and left == right:
    return F.conv2d(x, weight, None, stride, (top, left), groups=groups)
  x = F.pad(x, (left, right, top, bottom))
  return F.conv2d(x, weight, None, stride, 0, groups=groups)


class _SameConv(nn.Conv2d):
  """Bias-free ``nn.Conv2d`` with flax's ``"SAME"`` padding
  (``same_conv``)."""

  def __init__(self, in_channels: int, out_channels: int, kernel: int,
               stride: int = 1, groups: int = 1) -> None:
    super().__init__(in_channels, out_channels, kernel, stride=stride,
                     groups=groups, bias=False, device="meta")

  def same_padding(self, x: torch.Tensor) -> Tuple[int, int, int, int]:
    """(top, bottom, left, right): flax's ``"SAME"`` padding of x."""
    (kh, kw), (sh, sw) = self.kernel_size, self.stride
    return (*same_padding(x.shape[-2], kh, sh),
            *same_padding(x.shape[-1], kw, sw))

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    return same_conv(x, self.weight, self.stride, self.same_padding(x),
                     self.groups)


class InvertedResidual(nn.Module):
  """MobileNetV2 inverted residual block (expand -> depthwise -> project)."""

  def __init__(self, in_channels: int, out_channels: int, stride: int,
               expand_ratio: int) -> None:
    super().__init__()
    hidden = in_channels * expand_ratio
    self._use_residual = stride == 1 and in_channels == out_channels
    self._expands = expand_ratio != 1
    if self._expands:
      self.expand = _SameConv(in_channels, hidden, 1)
      self.expand_norm = _norm(hidden)
    self.depthwise = _SameConv(hidden, hidden, 3, stride=stride,
                               groups=hidden)
    self.depthwise_norm = _norm(hidden)
    self.project = _SameConv(hidden, out_channels, 1)
    self.project_norm = _norm(out_channels)

  def _depthwise(self, h: torch.Tensor) -> torch.Tensor:
    """``self.depthwise(h)``: one kernel launch where
    ``depthwise_cuda.engages(h)``, else PyTorch's operations."""
    if depthwise_cuda.engages(h):
      return depthwise_cuda.depthwise(h, self.depthwise.weight,
                                      self.depthwise.stride[0],
                                      self.depthwise.same_padding(h))
    return self.depthwise(h)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    h = x
    if self._expands:
      h = _normalise(self.expand_norm, self.expand(h), relu6=True)
    h = _normalise(self.depthwise_norm, self._depthwise(h), relu6=True)
    return _normalise(self.project_norm, self.project(h),
                      residual=x if self._use_residual else None)


def channels_of(ch: int, width_mult: float = 1.0) -> int:
  """MobileNetV2's channel rounding: ``ch`` scaled by ``width_mult`` and
  snapped to a multiple of 8, at least 8."""
  return max(8, int(ch * width_mult + 4) // 8 * 8)


class MobileNetV2(nn.Module):
  """MobileNetV2 feature extractor and classification head.

  Input: NCHW float images with ``in_channels`` channels (the BEV LIDAR
  has 2).  Output: ``[B, num_classes]``.  ``width_mult`` scales every
  channel count ``ch`` to ``max(8, int(ch * width_mult + 4) // 8 * 8)``
  (``channels``), as the JAX module does.
  """

  def __init__(self,
               in_channels: int = 2,
               num_classes: int = 128,
               *,
               width_mult: float = 1.0,
               generator: Optional[torch.Generator] = None,
               device="cuda") -> None:
    super().__init__()
    device = device_lib.resolve(device)
    c = functools.partial(channels_of, width_mult=width_mult)
    self.stem = _SameConv(in_channels, c(32), 3, stride=2)
    self.stem_norm = _norm(c(32))
    channels, block = c(32), 0
    for t, ch, n, s in _INVERTED_RESIDUAL_SETTINGS:
      for i in range(n):
        self.add_module("block_{}".format(block), InvertedResidual(
            channels, c(ch), stride=s if i == 0 else 1, expand_ratio=t))
        channels = c(ch)
        block += 1
    self._num_blocks = block
    self.head_conv = _SameConv(channels, c(1280), 1)
    self.head_norm = _norm(c(1280))
    self.classifier = nn.Linear(c(1280), num_classes, device="meta")
    initializers.materialize(self, generator, device)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    h = _normalise(self.stem_norm, self.stem(x), relu6=True)
    for i in range(self._num_blocks):
      h = getattr(self, "block_{}".format(i))(h)
    h = _normalise(self.head_norm, self.head_conv(h), relu6=True)
    return self.classifier(h.mean(dim=(-2, -1)))  # global average pool
