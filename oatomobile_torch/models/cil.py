"""The behavioural cloning model (conditional imitation learning): port of
the JAX package's ``models/cil.py``.

MobileNetV2(2ch) -> 128 features, concat [velocity(3),
is_at_traffic_light(1), traffic_light_state(1), mode(1)], MLP[64, 64, 64]
(activate_final) -> GRUCell(input=2, hidden=64) autoregressive residual
decoder -> plan [T=40, 2].
"""

from typing import Mapping, Optional, Tuple

import torch
from torch import nn

from oatomobile_torch import device as device_lib
from oatomobile_torch.models import initializers, transforms
from oatomobile_torch.models.dim import CONTEXT_KEYS, check_context
from oatomobile_torch.models.mlp import MLP
from oatomobile_torch.models.perception import MobileNetV2
from oatomobile_torch.models.sequence import GRUCell


class BehaviouralModel(nn.Module):
  """Deterministic autoregressive plan decoder."""

  def __init__(self,
               output_shape: Tuple[int, int] = (40, 2),
               input_size: Tuple[int, int] = (100, 100),
               *,
               generator: Optional[torch.Generator] = None,
               device="cuda") -> None:
    super().__init__()
    device = device_lib.resolve(device)
    self.output_shape = tuple(output_shape)
    self.input_size = tuple(input_size)
    self.encoder = MobileNetV2(in_channels=2, num_classes=128,
                               device="meta")
    self.merger = MLP(128 + 3 + 1 + 1 + 1, (64, 64, 64), activate_final=True,
                      device="meta")
    self.gru = GRUCell(self.output_shape[-1], 64, device="meta")
    self.output = nn.Linear(64, self.output_shape[-1], device="meta")
    initializers.materialize(self, generator, device)

  def forward(self, **context: torch.Tensor) -> torch.Tensor:
    """The expert plan [B, T, 2]."""
    check_context(context, CONTEXT_KEYS + ("mode",))
    features = self.encoder(context["visual_features"])
    z = torch.cat([
        features,
        context["velocity"],
        context["is_at_traffic_light"],
        context["traffic_light_state"],
        context["mode"],
    ], dim=-1)
    z = self.merger(z)
    x = torch.zeros(z.shape[:-1] + (self.output_shape[-1],), dtype=z.dtype,
                    device=z.device)
    ys = []
    for _ in range(self.output_shape[0]):
      z = self.gru(x, z)
      x = self.output(z) + x
      ys.append(x)
    return torch.stack(ys, dim=-2)

  def transform(
      self, sample: Mapping[str, torch.Tensor]) -> Mapping[str, torch.Tensor]:
    """Prepares raw sample variables: NHWC ``lidar`` becomes NCHW
    ``visual_features``, and the STOP command (1) becomes FORWARD (0) to
    avoid causal confusion with traffic lights."""
    sample = dict(sample)
    if "player_future" in sample:
      sample["player_future"] = transforms.downsample_target(
          sample["player_future"],
          num_timesteps_to_keep=self.output_shape[-2])
    if "lidar" in sample:
      sample["visual_features"] = sample.pop("lidar")
    if "visual_features" in sample:
      sample["visual_features"] = transforms.prepare_visual_features(
          sample["visual_features"], self.input_size)
    if "mode" in sample:
      mode = sample["mode"]
      sample["mode"] = torch.where(mode == 1.0, 0.0, mode)
    return sample
