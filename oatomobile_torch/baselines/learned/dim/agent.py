"""The deep imitative model agent for the single-scene API: port of the
JAX package's ``baselines/learned/dim/agent.py``.

Observation prep -> ``model.plan(num_steps=20, lr=5e-2)`` -> the 4-step
plan interpolated to 40 steps -> SetPointAgent PID tracking.
"""

from typing import Mapping

import numpy as np
import torch

import oatomobile_torch
from oatomobile_torch.baselines.base import SetPointAgent
from oatomobile_torch.baselines.learned import common
from oatomobile_torch.models.dim import CONTEXT_KEYS, ImitativeModel


class DIMAgent(SetPointAgent):
  """The deep imitative model agent."""

  def __init__(self, environment: oatomobile_torch.Env, *,
               model: ImitativeModel, **kwargs) -> None:
    """Args:
      model: the ImitativeModel with its weights (the JAX agent takes the
        flax module and its parameters apart); its parameters are frozen.
        Planning runs on the model's device.
    """
    super().__init__(environment=environment, **kwargs)
    model.requires_grad_(False)
    model.eval()
    self._model = model

  def __call__(self, observation: Mapping[str, np.ndarray],
               **kwargs) -> np.ndarray:
    obs = common.prepare_observation(observation)
    sample = self._model.transform(common.model_inputs(obs, self._model))
    context = common.model_context(sample, CONTEXT_KEYS)
    with torch.no_grad():
      plan = self._model.plan(num_steps=kwargs.get("num_steps", 20),
                              goal=sample.get("goal"),
                              lr=kwargs.get("lr", 5e-2),
                              epsilon=kwargs.get("epsilon", 1.0), **context)
    return common.interpolate_plan(plan[0].cpu().numpy())  # [T, 2] -> 3D
