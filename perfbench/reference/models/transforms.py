"""Preprocessing transforms shared by the models: port of the JAX
package's ``models/transforms.py``.

The JAX transforms take NHWC images; these take the port's NCHW layout
``[..., C, H, W]``.  ``sensors.synth.lidar`` gives NHWC ``[B, 200, 200, 2]``:
the models' ``transform`` moves it to NCHW first.
"""

from typing import Tuple

import torch
import torch.nn.functional as F


def downsample_target(player_future: torch.Tensor,
                      num_timesteps_to_keep: int) -> torch.Tensor:
  """Strided subsampling of the target sequence ``[..., T, D]``."""
  T = player_future.shape[-2]
  increments = T // num_timesteps_to_keep
  return player_future[..., ::increments, :][..., :num_timesteps_to_keep, :]


def downsample_visual_features(visual_features: torch.Tensor,
                               output_shape: Tuple[int, int]) -> torch.Tensor:
  """Bilinear resize of ``[..., C, H, W]`` images with half-pixel centres
  and antialiasing, as ``jax.image.resize(..., "bilinear")`` (whose
  ``antialias`` defaults to True)."""
  batch = visual_features.shape[:-3]
  x = visual_features.reshape((-1,) + visual_features.shape[-3:])
  x = F.interpolate(x, size=tuple(output_shape), mode="bilinear",
                    align_corners=False, antialias=True)
  return x.reshape(batch + x.shape[-3:])


def transpose_visual_features(visual_features: torch.Tensor) -> torch.Tensor:
  """Swaps the two spatial dims of ``[..., C, H, W]`` (the JAX package
  swaps NHWC dims -3 and -2)."""
  return visual_features.transpose(-2, -1)


def prepare_visual_features(images: torch.Tensor,
                            input_size: Tuple[int, int]) -> torch.Tensor:
  """NHWC ``[..., H, W, C]`` images (the BEV LIDAR) to the models' NCHW
  visual features: downsampled to ``input_size`` and transposed, as the
  models' ``transform`` does in the JAX package."""
  nchw = images.movedim(-1, -3)
  return transpose_visual_features(
      downsample_visual_features(nchw, output_shape=input_size))
