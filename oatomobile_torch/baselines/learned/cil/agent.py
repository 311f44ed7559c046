"""The conditional imitation learning agent for the single-scene API: port
of the JAX package's ``baselines/learned/cil/agent.py``.

Observation prep + the command (mode) from the goal's geometry ->
BehaviouralModel plan -> interpolation -> SetPointAgent PID tracking.
The forward runs as a ``common.CapturedAct``, as the JAX agent jits it;
the mode is computed on the host and copied in with the observation.
"""

import functools
from typing import Mapping

import numpy as np
import torch

import oatomobile_torch
from oatomobile_torch.baselines.base import SetPointAgent
from oatomobile_torch.baselines.learned import common
from oatomobile_torch.models.cil import BehaviouralModel
from oatomobile_torch.models.dim import CONTEXT_KEYS


def cil_forward(model: BehaviouralModel,
                inputs: Mapping[str, torch.Tensor]) -> torch.Tensor:
  """The plan [1, T, 2] from a ``CapturedAct``'s inputs (the raw
  observation's model keys and the mode)."""
  sample = model.transform(inputs)
  context = common.model_context(sample, CONTEXT_KEYS + ("mode",))
  with torch.no_grad():
    return model(**context)


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
    self._forward = common.CapturedAct(functools.partial(cil_forward, model),
                                       next(model.parameters()).device)

  def __call__(self, observation: Mapping[str, np.ndarray],
               **kwargs) -> np.ndarray:
    obs = common.prepare_observation(observation)
    # The command from the goal endpoint (signed angle, see
    # common.mode_from_goal).
    obs["mode"] = np.atleast_2d(common.mode_from_goal(obs["goal"]))
    plan = self._forward(common.act_inputs(obs))
    return common.interpolate_plan(plan)  # [T, 2] -> 3D
