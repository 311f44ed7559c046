"""TransFuser of the reference (Prakash, Chitta and Geiger, CVPR 2021,
arXiv:2104.09224), written from the equations of the authors' code
(github.com/autonomousvision/transfuser, branch ``cvpr2021``,
``transfuser/model.py``: ``ImageCNN``, ``LidarEncoder``,
``SelfAttention``, ``Block``, ``GPT``, ``Encoder``, ``TransFuser``) at
the sizes of its ``transfuser/config.py``, with its parameter names, in
IEEE float32 (the caller turns TF32 off).

The camera and the LiDAR trunk (ResNet-34, ResNet-18 with a 2-channel
stem) are fused after each stage by a GPT over the two maps' 8 x 8 anchor
tokens; the fused features feed a join MLP and a GRU that adds one
waypoint offset a step.  Dropout is left out (off at inference); the
camera image comes in ImageNet-normalised (``normalize_imagenet``).
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from perfbench.reference.models import resnet

N_LAYER = 8
N_HEAD = 4
BLOCK_EXP = 4
ANCHORS = 8
PRED_LEN = 4


def normalize_imagenet(x: torch.Tensor) -> torch.Tensor:
  x = x.clone()
  x[:, 0] = (x[:, 0] - 0.485) / 0.229
  x[:, 1] = (x[:, 1] - 0.456) / 0.224
  x[:, 2] = (x[:, 2] - 0.406) / 0.225
  return x


class SelfAttention(nn.Module):

  def __init__(self, n_embd: int, n_head: int) -> None:
    super().__init__()
    self.key = nn.Linear(n_embd, n_embd)
    self.query = nn.Linear(n_embd, n_embd)
    self.value = nn.Linear(n_embd, n_embd)
    self.proj = nn.Linear(n_embd, n_embd)
    self.n_head = n_head

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    B, T, C = x.size()
    k = self.key(x).view(B, T, self.n_head, C // self.n_head).transpose(1, 2)
    q = self.query(x).view(B, T, self.n_head,
                           C // self.n_head).transpose(1, 2)
    v = self.value(x).view(B, T, self.n_head,
                           C // self.n_head).transpose(1, 2)
    att = (q @ k.transpose(-2, -1)) * (1.0 / math.sqrt(k.size(-1)))
    att = F.softmax(att, dim=-1)
    y = att @ v
    y = y.transpose(1, 2).contiguous().view(B, T, C)
    return self.proj(y)


class Block(nn.Module):

  def __init__(self, n_embd: int, n_head: int, block_exp: int) -> None:
    super().__init__()
    self.ln1 = nn.LayerNorm(n_embd)
    self.ln2 = nn.LayerNorm(n_embd)
    self.attn = SelfAttention(n_embd, n_head)
    self.mlp = nn.Sequential(nn.Linear(n_embd, block_exp * n_embd),
                             nn.ReLU(True),
                             nn.Linear(block_exp * n_embd, n_embd))

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    x = x + self.attn(self.ln1(x))
    x = x + self.mlp(self.ln2(x))
    return x


class GPT(nn.Module):

  def __init__(self, n_embd: int) -> None:
    super().__init__()
    self.n_embd = n_embd
    self.pos_emb = nn.Parameter(torch.zeros(1, 2 * ANCHORS * ANCHORS,
                                            n_embd))
    self.vel_emb = nn.Linear(1, n_embd)
    self.blocks = nn.Sequential(*[Block(n_embd, N_HEAD, BLOCK_EXP)
                                  for _ in range(N_LAYER)])
    self.ln_f = nn.LayerNorm(n_embd)

  def forward(self, image_tensor, lidar_tensor, velocity):
    bz = lidar_tensor.shape[0]
    h, w = lidar_tensor.shape[2:4]
    image_tensor = image_tensor.view(bz, 1, -1, h, w)
    lidar_tensor = lidar_tensor.view(bz, 1, -1, h, w)
    token_embeddings = torch.cat([image_tensor, lidar_tensor],
                                 dim=1).permute(0, 1, 3, 4, 2).contiguous()
    token_embeddings = token_embeddings.view(bz, -1, self.n_embd)
    velocity_embeddings = self.vel_emb(velocity.unsqueeze(1))
    x = self.pos_emb + token_embeddings + velocity_embeddings.unsqueeze(1)
    x = self.blocks(x)
    x = self.ln_f(x)
    x = x.view(bz, 2, h, w, self.n_embd)
    x = x.permute(0, 1, 4, 2, 3).contiguous()
    image_tensor_out = x[:, :1, :, :, :].contiguous().view(bz, -1, h, w)
    lidar_tensor_out = x[:, 1:, :, :, :].contiguous().view(bz, -1, h, w)
    return image_tensor_out, lidar_tensor_out


class ImageCNN(nn.Module):

  def __init__(self) -> None:
    super().__init__()
    self.features = resnet.resnet34(3)


class LidarEncoder(nn.Module):

  def __init__(self) -> None:
    super().__init__()
    self._model = resnet.resnet18(2)


class Encoder(nn.Module):

  def __init__(self) -> None:
    super().__init__()
    self.avgpool = nn.AdaptiveAvgPool2d((ANCHORS, ANCHORS))
    self.image_encoder = ImageCNN()
    self.lidar_encoder = LidarEncoder()
    self.transformer1 = GPT(64)
    self.transformer2 = GPT(128)
    self.transformer3 = GPT(256)
    self.transformer4 = GPT(512)

  def _fuse(self, transformer, image_features, lidar_features, velocity,
            scale: int):
    image_embd = self.avgpool(image_features)
    lidar_embd = self.avgpool(lidar_features)
    image_embd, lidar_embd = transformer(image_embd, lidar_embd, velocity)
    image_embd = F.interpolate(image_embd, scale_factor=scale,
                               mode="bilinear", align_corners=False)
    lidar_embd = F.interpolate(lidar_embd, scale_factor=scale,
                               mode="bilinear", align_corners=False)
    return image_features + image_embd, lidar_features + lidar_embd

  def forward(self, image, lidar, velocity):
    img = self.image_encoder.features
    lid = self.lidar_encoder._model  # pylint: disable=protected-access
    bz = lidar.shape[0]
    image_features = img.maxpool(img.relu(img.bn1(img.conv1(image))))
    lidar_features = lid.maxpool(lid.relu(lid.bn1(lid.conv1(lidar))))

    image_features = img.layer1(image_features)
    lidar_features = lid.layer1(lidar_features)
    image_features, lidar_features = self._fuse(
        self.transformer1, image_features, lidar_features, velocity, 8)
    image_features = img.layer2(image_features)
    lidar_features = lid.layer2(lidar_features)
    image_features, lidar_features = self._fuse(
        self.transformer2, image_features, lidar_features, velocity, 4)
    image_features = img.layer3(image_features)
    lidar_features = lid.layer3(lidar_features)
    image_features, lidar_features = self._fuse(
        self.transformer3, image_features, lidar_features, velocity, 2)
    image_features = img.layer4(image_features)
    lidar_features = lid.layer4(lidar_features)
    image_features, lidar_features = self._fuse(
        self.transformer4, image_features, lidar_features, velocity, 1)

    image_features = F.adaptive_avg_pool2d(image_features, (1, 1))
    image_features = torch.flatten(image_features, 1).view(bz, 1, -1)
    lidar_features = F.adaptive_avg_pool2d(lidar_features, (1, 1))
    lidar_features = torch.flatten(lidar_features, 1).view(bz, 1, -1)
    fused_features = torch.cat([image_features, lidar_features], dim=1)
    return torch.sum(fused_features, dim=1)


class TransFuser(nn.Module):
  """``forward(image, lidar, speed, target_point) -> [B, 4, 2]``."""

  def __init__(self, device=None) -> None:
    super().__init__()
    with torch.device(device or "cpu"):
      self.encoder = Encoder()
      self.join = nn.Sequential(nn.Linear(512, 256), nn.ReLU(inplace=True),
                                nn.Linear(256, 128), nn.ReLU(inplace=True),
                                nn.Linear(128, 64), nn.ReLU(inplace=True))
      self.decoder = nn.GRUCell(input_size=4, hidden_size=64)
      self.output = nn.Linear(64, 2)

  def decode(self, fused_features, target_point):
    z = self.join(fused_features)
    output_wp = []
    x = torch.zeros(size=(z.shape[0], 2), dtype=z.dtype, device=z.device)
    for _ in range(PRED_LEN):
      x_in = torch.cat([x, target_point], dim=1)
      z = self.decoder(x_in, z)
      dx = self.output(z)
      x = dx + x
      output_wp.append(x)
    return torch.stack(output_wp, dim=1)

  def forward(self, image, lidar, speed, target_point):
    return self.decode(self.encoder(image, lidar, speed), target_point)
