"""ResNet trunks of the BasicBlock kind (ResNet-18 and ResNet-34), as
TransFuser's camera and LiDAR encoders use them (He et al., CVPR 2016;
the layout of ``torchvision.models.resnet``, whose parameter names this
module keeps, so that a torchvision or TransFuser checkpoint loads).

  - the stem: a 7x7 stride-2 convolution, BatchNorm, ReLU and a 3x3
    stride-2 max-pool;
  - four stages of BasicBlocks (two 3x3 convolutions, each followed by
    BatchNorm; a 1x1 stride-2 convolution and BatchNorm project the
    shortcut where the shape changes), at 64, 128, 256 and 512 channels;
  - no classifier: the trunk ends with the last stage's map.

``in_channels`` sets the stem's input (3 for a camera, 2 for the BEV
LiDAR histogram).  The stem and each stage are callable on their own
(``stem``, ``stage``), because TransFuser fuses the two trunks between
stages.  BatchNorm follows the module's mode: in eval mode it normalises
with the running statistics.
"""

from typing import Sequence

import torch
from torch import nn

STAGE_CHANNELS = (64, 128, 256, 512)
RESNET18 = (2, 2, 2, 2)
RESNET34 = (3, 4, 6, 3)


class BasicBlock(nn.Module):
  """Two 3x3 convolutions with BatchNorm and a residual shortcut."""

  def __init__(self, in_channels: int, channels: int, stride: int) -> None:
    super().__init__()
    self.conv1 = nn.Conv2d(in_channels, channels, 3, stride=stride,
                           padding=1, bias=False)
    self.bn1 = nn.BatchNorm2d(channels)
    self.relu = nn.ReLU(inplace=True)
    self.conv2 = nn.Conv2d(channels, channels, 3, padding=1, bias=False)
    self.bn2 = nn.BatchNorm2d(channels)
    self.downsample = None
    if stride != 1 or in_channels != channels:
      self.downsample = nn.Sequential(
          nn.Conv2d(in_channels, channels, 1, stride=stride, bias=False),
          nn.BatchNorm2d(channels))

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    identity = x
    out = self.relu(self.bn1(self.conv1(x)))
    out = self.bn2(self.conv2(out))
    if self.downsample is not None:
      identity = self.downsample(x)
    out += identity
    return self.relu(out)


class ResNet(nn.Module):
  """A BasicBlock ResNet trunk with ``blocks`` blocks a stage."""

  def __init__(self, blocks: Sequence[int], in_channels: int = 3) -> None:
    super().__init__()
    if len(blocks) != len(STAGE_CHANNELS):
      raise ValueError("blocks {}: one count for each of {} stages".format(
          tuple(blocks), len(STAGE_CHANNELS)))
    self.blocks = tuple(blocks)
    self.in_channels = in_channels
    self.conv1 = nn.Conv2d(in_channels, STAGE_CHANNELS[0], 7, stride=2,
                           padding=3, bias=False)
    self.bn1 = nn.BatchNorm2d(STAGE_CHANNELS[0])
    self.relu = nn.ReLU(inplace=True)
    self.maxpool = nn.MaxPool2d(kernel_size=3, stride=2, padding=1)
    width = STAGE_CHANNELS[0]
    for i, (count, channels) in enumerate(zip(blocks, STAGE_CHANNELS)):
      stride = 1 if i == 0 else 2
      layers = []
      for j in range(count):
        layers.append(BasicBlock(width, channels, stride if j == 0 else 1))
        width = channels
      self.add_module("layer{}".format(i + 1), nn.Sequential(*layers))

  def stem(self, x: torch.Tensor) -> torch.Tensor:
    """[B, in_channels, H, W] -> [B, 64, H / 4, W / 4]."""
    return self.maxpool(self.relu(self.bn1(self.conv1(x))))

  def stage(self, index: int, x: torch.Tensor) -> torch.Tensor:
    """Stage ``index`` (0 to 3) of the trunk."""
    return getattr(self, "layer{}".format(index + 1))(x)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    x = self.stem(x)
    for i in range(len(STAGE_CHANNELS)):
      x = self.stage(i, x)
    return x

