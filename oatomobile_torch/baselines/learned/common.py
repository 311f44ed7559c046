"""Shared observation preparation for the single-scene learned agents: a
copy of the JAX package's ``baselines/learned/common.py`` (batchify,
goal -> 2D, the command from the goal's geometry, the 4 -> 40 plan
interpolation with an appended z column), plus ``model_inputs``, which
moves what a model reads to its device.
"""

from typing import Mapping, Sequence

import numpy as np
import torch

PLAYER_FUTURE_LENGTH = 40


def prepare_observation(
    observation: Mapping[str, np.ndarray]) -> Mapping[str, np.ndarray]:
  """Batchifies raw observations; goal trimmed to 2D; images stay NHWC
  (the models' ``transform`` makes them NCHW)."""
  out = {}
  for attr, value in observation.items():
    value = np.asarray(value) if isinstance(value, np.ndarray) else \
        np.atleast_1d(np.asarray(value, dtype=np.float32))
    out[attr] = value[None, ...].astype(np.float32)
  if "bird_view_camera_cityscapes" in out:
    out["overhead_features"] = out["bird_view_camera_cityscapes"]
  if "goal" in out:
    out["goal"] = out["goal"][..., :2]
  return out


def mode_from_goal(goal: np.ndarray, signed: bool = True) -> float:
  """Command label {0 FORWARD, 1 STOP, 2 LEFT, 3 RIGHT} from the goal
  endpoint geometry.

  The reference has two conflicting rules (datasets/carla.py:150-157 uses
  theta <= -15 for RIGHT — unreachable since arccos >= 0; cil/agent.py:67-74
  uses theta <= 15 — which also swallows FORWARD).  The ``signed`` variant
  resolves the bug with a signed angle; pass signed=False for the dataset
  rule.
  """
  x_t, y_t = goal[0, -1, :2]
  norm = float(np.linalg.norm([x_t, y_t]))
  if norm < 3:
    return 1.0  # STOP
  if signed:
    theta = float(np.degrees(np.arctan2(y_t, x_t)))
    if theta > 15:
      return 3.0  # RIGHT (+y is the right-hand side)
    if theta < -15:
      return 2.0  # LEFT
    return 0.0
  theta = float(np.degrees(np.arccos(x_t / (norm + 1e-3))))
  if theta > 15:
    return 2.0
  if theta <= -15:
    return 3.0
  return 0.0


def interpolate_plan(plan: np.ndarray,
                     length: int = PLAYER_FUTURE_LENGTH) -> np.ndarray:
  """Linear 1-D interpolation of a [T, 2] plan to [length-step, 3]
  (x, y, z=0), matching the agents' scipy.interp1d usage
  (e.g. dim/agent.py:75-84)."""
  T = plan.shape[0]
  increments = length // T
  time_index = np.arange(0, length, increments)[:T]
  dense_t = np.arange(0, time_index[-1])
  xy = np.stack(
      [np.interp(dense_t, time_index, plan[:, d]) for d in range(2)],
      axis=-1)
  z = np.zeros((xy.shape[0], 1))
  return np.concatenate([xy, z], axis=-1)


# What the learned models read of a prepared observation.
MODEL_KEYS = ("lidar", "visual_features", "velocity", "is_at_traffic_light",
              "traffic_light_state", "goal", "mode")


def model_inputs(obs: Mapping[str, np.ndarray],
                 model: torch.nn.Module) -> dict:
  """The entries of ``obs`` that a model reads, as float32 tensors on the
  model's device."""
  device = next(model.parameters()).device
  return {k: torch.as_tensor(v, dtype=torch.float32, device=device)
          for k, v in obs.items() if k in MODEL_KEYS}


def model_context(sample: Mapping[str, torch.Tensor],
                  keys: Sequence[str]) -> dict:
  """The model's context from a transformed sample: scalars that arrive
  as [1] become [B, 1], as the models expect."""
  context = {k: sample[k] for k in keys if k in sample}
  for key in ("is_at_traffic_light", "traffic_light_state"):
    if key in context and context[key].dim() == 1:
      context[key] = context[key][:, None]
  return context
