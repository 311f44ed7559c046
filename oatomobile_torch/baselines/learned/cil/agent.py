"""The conditional imitation learning agent for the single-scene API: port
of the JAX package's ``baselines/learned/cil/agent.py``.

Observation prep + the command (mode) from the goal's geometry ->
BehaviouralModel plan -> interpolation -> SetPointAgent PID tracking.
"""

from typing import Mapping

import numpy as np
import torch

import oatomobile_torch
from oatomobile_torch.baselines.base import SetPointAgent
from oatomobile_torch.baselines.learned import common
from oatomobile_torch.models.cil import BehaviouralModel
from oatomobile_torch.models.dim import CONTEXT_KEYS


class CILAgent(SetPointAgent):
  """The conditional imitation learning agent."""

  def __init__(self, environment: oatomobile_torch.Env, *,
               model: BehaviouralModel, **kwargs) -> None:
    """Args:
      model: the BehaviouralModel with its weights; its parameters are
        frozen.  It runs on its own device.
    """
    super().__init__(environment=environment, **kwargs)
    model.requires_grad_(False)
    model.eval()
    self._model = model

  def __call__(self, observation: Mapping[str, np.ndarray],
               **kwargs) -> np.ndarray:
    obs = common.prepare_observation(observation)
    # The command from the goal endpoint (signed angle, see
    # common.mode_from_goal).
    obs["mode"] = np.atleast_2d(common.mode_from_goal(obs["goal"]))
    sample = self._model.transform(common.model_inputs(obs, self._model))
    context = common.model_context(sample, CONTEXT_KEYS + ("mode",))
    with torch.no_grad():
      plan = self._model(**context)
    return common.interpolate_plan(plan[0].cpu().numpy())  # [T, 2] -> 3D
