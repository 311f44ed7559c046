"""TransFuser: the camera + LiDAR fusion transformer of Prakash, Chitta
and Geiger, "Multi-Modal Fusion Transformer for End-to-End Autonomous
Driving" (CVPR 2021, arXiv:2104.09224), as the authors' code has it
(github.com/autonomousvision/transfuser, branch ``cvpr2021``,
``transfuser/model.py``; the sizes of ``transfuser/config.py``).

  - two trunks, one a sensor: ResNet-34 on the front camera (3 x 256 x
    256, ImageNet-normalised) and ResNet-18 on the BEV LiDAR histogram
    (2 x 256 x 256) (``models/resnet.py``);
  - after each of the four stages (C = 64, 128, 256, 512 channels) both
    maps are average-pooled to 8 x 8 anchors and become 2 x 64 tokens of
    width C (camera tokens in raster order, then LiDAR tokens); a learned
    position embedding and ``Linear(1, C)`` of the ego speed are added;
    a GPT of 8 pre-LayerNorm blocks (4 heads, unmasked softmax attention,
    an MLP of C -> 4C -> C with ReLU) and a final LayerNorm transform
    them; the output is split back into the two 8 x 8 maps, each is
    bilinearly upsampled to its trunk's map and added to the trunk's
    features;
  - after stage 4 each trunk is average-pooled to 512 values and the two
    vectors are summed; the join MLP (512 -> 256 -> 128 -> 64, ReLU after
    each) gives the GRU's first state, and a ``torch.nn.GRUCell(4, 64)``
    runs ``PRED_LEN`` (4) steps on ``cat(x, target_point)``, each adding
    ``Linear(64, 2)`` of its state to the waypoint ``x``.

Dropout (0.1 in the source's configuration) is left out: it is off at
inference.  Every operation is the source's, in the source's order, on
plain PyTorch operations in float32; attention is written out (``q @
k^T`` times ``1 / sqrt(d_head)``, softmax, ``@ v``), not a fused
attention kernel.  Module and parameter names are the source's, so a
checkpoint of the source loads.

The encoder marks each stage's trunks as the span ``transfuser.trunk``
(``count``: the BasicBlocks run) and each fusion (pooling, GPT,
upsampling, add) as ``transfuser.fuse`` (``count``: the GPT's blocks) on
the device clock (``utils.profiling``); the policy
(``baselines/learned/transfuser``) marks the rest.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from oatomobile_torch.models import resnet
from oatomobile_torch.utils import profiling

# The sizes of the source's ``transfuser/config.py``.
INPUT_SIZE = 256              # the camera's and the LiDAR's square inputs
ANCHORS = 8                   # vert_anchors = horz_anchors
N_LAYER = 8
N_HEAD = 4
BLOCK_EXP = 4
JOIN = (256, 128, 64)
PRED_LEN = 4

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_imagenet(x: torch.Tensor) -> torch.Tensor:
  """[B, 3, H, W] RGB in [0, 1], each channel less ImageNet's mean over
  its standard deviation (the source's ``normalize_imagenet``)."""
  x = x.clone()
  for c, (mean, std) in enumerate(zip(IMAGENET_MEAN, IMAGENET_STD)):
    x[:, c] = (x[:, c] - mean) / std
  return x


class SelfAttention(nn.Module):
  """Unmasked multi-head self-attention with separate key, query and
  value projections and an output projection."""

  def __init__(self, n_embd: int) -> None:
    super().__init__()
    self.key = nn.Linear(n_embd, n_embd)
    self.query = nn.Linear(n_embd, n_embd)
    self.value = nn.Linear(n_embd, n_embd)
    self.proj = nn.Linear(n_embd, n_embd)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    B, T, C = x.size()
    hs = C // N_HEAD
    k = self.key(x).view(B, T, N_HEAD, hs).transpose(1, 2)
    q = self.query(x).view(B, T, N_HEAD, hs).transpose(1, 2)
    v = self.value(x).view(B, T, N_HEAD, hs).transpose(1, 2)
    att = (q @ k.transpose(-2, -1)) * (1.0 / math.sqrt(k.size(-1)))
    att = F.softmax(att, dim=-1)
    y = att @ v
    y = y.transpose(1, 2).contiguous().view(B, T, C)
    return self.proj(y)


class Block(nn.Module):
  """A pre-LayerNorm transformer block."""

  def __init__(self, n_embd: int) -> None:
    super().__init__()
    self.ln1 = nn.LayerNorm(n_embd)
    self.ln2 = nn.LayerNorm(n_embd)
    self.attn = SelfAttention(n_embd)
    self.mlp = nn.Sequential(
        nn.Linear(n_embd, BLOCK_EXP * n_embd),
        nn.ReLU(True),
        nn.Linear(BLOCK_EXP * n_embd, n_embd),
    )

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    x = x + self.attn(self.ln1(x))
    return x + self.mlp(self.ln2(x))


class GPT(nn.Module):
  """The fusion transformer of one scale: camera and LiDAR anchor maps
  [B, C, h, w] in, the same two maps out."""

  def __init__(self, n_embd: int) -> None:
    super().__init__()
    self.n_embd = n_embd
    # One camera view and one LiDAR map, a sequence of one frame each.
    self.pos_emb = nn.Parameter(torch.zeros(1, 2 * ANCHORS * ANCHORS,
                                            n_embd))
    self.vel_emb = nn.Linear(1, n_embd)
    self.blocks = nn.Sequential(*[Block(n_embd) for _ in range(N_LAYER)])
    self.ln_f = nn.LayerNorm(n_embd)

  def forward(self, image: torch.Tensor, lidar: torch.Tensor,
              velocity: torch.Tensor):
    bz = lidar.shape[0]
    h, w = lidar.shape[2:4]
    image = image.view(bz, 1, -1, h, w)
    lidar = lidar.view(bz, 1, -1, h, w)
    tokens = torch.cat([image, lidar], dim=1).permute(0, 1, 3, 4,
                                                      2).contiguous()
    tokens = tokens.view(bz, -1, self.n_embd)
    velocity_embeddings = self.vel_emb(velocity.unsqueeze(1))
    x = self.pos_emb + tokens + velocity_embeddings.unsqueeze(1)
    x = self.blocks(x)
    x = self.ln_f(x)
    x = x.view(bz, 2, h, w, self.n_embd).permute(0, 1, 4, 2, 3).contiguous()
    image_out = x[:, :1].contiguous().view(bz, -1, h, w)
    lidar_out = x[:, 1:].contiguous().view(bz, -1, h, w)
    return image_out, lidar_out


class ImageCNN(nn.Module):
  """The camera trunk, ResNet-34 (the source's name: its ResNet is
  ``features``)."""

  def __init__(self) -> None:
    super().__init__()
    self.features = resnet.ResNet(resnet.RESNET34, in_channels=3)


class LidarEncoder(nn.Module):
  """The LiDAR trunk, ResNet-18 on the BEV's two channels (the source's
  name: its ResNet is ``_model``)."""

  def __init__(self) -> None:
    super().__init__()
    self._model = resnet.ResNet(resnet.RESNET18, in_channels=2)


class Encoder(nn.Module):
  """Both trunks with a fusion after each stage: [B, 512] features."""

  def __init__(self) -> None:
    super().__init__()
    self.avgpool = nn.AdaptiveAvgPool2d((ANCHORS, ANCHORS))
    self.image_encoder = ImageCNN()
    self.lidar_encoder = LidarEncoder()
    for i, width in enumerate(resnet.STAGE_CHANNELS):
      self.add_module("transformer{}".format(i + 1), GPT(width))

  def forward(self, image: torch.Tensor, lidar: torch.Tensor,
              velocity: torch.Tensor) -> torch.Tensor:
    """``image`` [B, 3, H, W] (ImageNet-normalised), ``lidar`` [B, 2, H,
    W], ``velocity`` [B] m/s -> [B, 512]."""
    camera = self.image_encoder.features
    bev = self.lidar_encoder._model  # pylint: disable=protected-access
    device = image.device
    image_features = lidar_features = None
    for s in range(len(resnet.STAGE_CHANNELS)):
      blocks = camera.blocks[s] + bev.blocks[s]
      with profiling.span("transfuser.trunk", device, count=blocks):
        if s == 0:
          image_features = camera.stem(image)
          lidar_features = bev.stem(lidar)
        image_features = camera.stage(s, image_features)
        lidar_features = bev.stage(s, lidar_features)
      transformer = getattr(self, "transformer{}".format(s + 1))
      with profiling.span("transfuser.fuse", device, count=N_LAYER):
        scale = image_features.shape[-1] // ANCHORS
        image_embd = self.avgpool(image_features)
        lidar_embd = self.avgpool(lidar_features)
        image_embd, lidar_embd = transformer(image_embd, lidar_embd,
                                             velocity)
        image_embd = F.interpolate(image_embd, scale_factor=scale,
                                   mode="bilinear", align_corners=False)
        lidar_embd = F.interpolate(lidar_embd, scale_factor=scale,
                                   mode="bilinear", align_corners=False)
        image_features = image_features + image_embd
        lidar_features = lidar_features + lidar_embd
    image_features = torch.flatten(F.adaptive_avg_pool2d(image_features, 1),
                                   1).view(image.shape[0], 1, -1)
    lidar_features = torch.flatten(F.adaptive_avg_pool2d(lidar_features, 1),
                                   1).view(lidar.shape[0], 1, -1)
    fused = torch.cat([image_features, lidar_features], dim=1)
    return torch.sum(fused, dim=1)


class TransFuser(nn.Module):
  """``forward(image, lidar, speed, target_point) -> [B, PRED_LEN, 2]``
  ego-frame waypoints; ``encode`` and ``decode`` are its two halves."""

  def __init__(self, device=None) -> None:
    super().__init__()
    with torch.device(device or "cpu"):
      self.encoder = Encoder()
      widths = (resnet.STAGE_CHANNELS[-1],) + JOIN
      layers = []
      for fan_in, fan_out in zip(widths[:-1], widths[1:]):
        layers += [nn.Linear(fan_in, fan_out), nn.ReLU(inplace=True)]
      self.join = nn.Sequential(*layers)
      self.decoder = nn.GRUCell(input_size=4, hidden_size=widths[-1])
      self.output = nn.Linear(widths[-1], 2)

  def encode(self, image: torch.Tensor, lidar: torch.Tensor,
             speed: torch.Tensor) -> torch.Tensor:
    """[B, 512]: both trunks with the four fusions, pooled and summed."""
    return self.encoder(image, lidar, speed)

  def decode(self, features: torch.Tensor,
             target_point: torch.Tensor) -> torch.Tensor:
    """[B, PRED_LEN, 2]: the join MLP, then the GRU's waypoint steps."""
    z = self.join(features)
    x = torch.zeros(size=(z.shape[0], 2), dtype=z.dtype, device=z.device)
    output_wp = []
    for _ in range(PRED_LEN):
      x_in = torch.cat([x, target_point], dim=1)
      z = self.decoder(x_in, z)
      dx = self.output(z)
      x = dx + x
      output_wp.append(x)
    return torch.stack(output_wp, dim=1)

  def forward(self, image: torch.Tensor, lidar: torch.Tensor,
              speed: torch.Tensor,
              target_point: torch.Tensor) -> torch.Tensor:
    return self.decode(self.encode(image, lidar, speed), target_point)
