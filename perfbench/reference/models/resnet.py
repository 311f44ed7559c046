"""ResNet trunks of the reference (He et al., CVPR 2016), written from
the equations of ``torchvision.models.resnet`` (BasicBlock, ResNet-18
and ResNet-34) with its parameter names, and no classifier: TransFuser's
two trunks.  BatchNorm normalises with the running statistics in eval
mode."""

from typing import Sequence

import torch
from torch import nn

WIDTHS = (64, 128, 256, 512)


def conv3x3(cin: int, cout: int, stride: int = 1) -> nn.Conv2d:
  return nn.Conv2d(cin, cout, kernel_size=3, stride=stride, padding=1,
                   bias=False)


class BasicBlock(nn.Module):
  """relu(bn2(conv2(relu(bn1(conv1(x))))) + shortcut(x))."""

  def __init__(self, cin: int, cout: int, stride: int = 1) -> None:
    super().__init__()
    self.conv1 = conv3x3(cin, cout, stride)
    self.bn1 = nn.BatchNorm2d(cout)
    self.relu = nn.ReLU(inplace=True)
    self.conv2 = conv3x3(cout, cout)
    self.bn2 = nn.BatchNorm2d(cout)
    self.downsample = None
    if stride != 1 or cin != cout:
      self.downsample = nn.Sequential(
          nn.Conv2d(cin, cout, kernel_size=1, stride=stride, bias=False),
          nn.BatchNorm2d(cout))

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    identity = x
    out = self.conv1(x)
    out = self.bn1(out)
    out = self.relu(out)
    out = self.conv2(out)
    out = self.bn2(out)
    if self.downsample is not None:
      identity = self.downsample(x)
    out += identity
    out = self.relu(out)
    return out


class ResNet(nn.Module):
  """conv1 (7x7/2), bn1, relu, maxpool (3x3/2), layer1 to layer4."""

  def __init__(self, layers: Sequence[int], in_channels: int = 3) -> None:
    super().__init__()
    self.conv1 = nn.Conv2d(in_channels, 64, kernel_size=7, stride=2,
                           padding=3, bias=False)
    self.bn1 = nn.BatchNorm2d(64)
    self.relu = nn.ReLU(inplace=True)
    self.maxpool = nn.MaxPool2d(kernel_size=3, stride=2, padding=1)
    cin = 64
    for i, (n, cout) in enumerate(zip(layers, WIDTHS)):
      blocks = [BasicBlock(cin, cout, 1 if i == 0 else 2)]
      blocks += [BasicBlock(cout, cout) for _ in range(n - 1)]
      setattr(self, "layer%d" % (i + 1), nn.Sequential(*blocks))
      cin = cout


def resnet18(in_channels: int = 3) -> ResNet:
  return ResNet((2, 2, 2, 2), in_channels)


def resnet34(in_channels: int = 3) -> ResNet:
  return ResNet((3, 4, 6, 3), in_channels)
