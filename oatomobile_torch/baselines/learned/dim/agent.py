"""The deep imitative model agent for the single-scene API: port of the
JAX package's ``baselines/learned/dim/agent.py``.

Observation prep -> ``model.plan(num_steps=20, lr=5e-2)`` -> the 4-step
plan interpolated to 40 steps -> SetPointAgent PID tracking.  The plan
runs as a ``common.CapturedAct`` (one captured step per ``num_steps``,
``lr`` and ``epsilon`` read from 0-d buffers), as the JAX agent jits it
with ``num_steps`` static.
"""

import functools
from typing import Mapping

import numpy as np
import torch

import oatomobile_torch
from oatomobile_torch.baselines.base import SetPointAgent
from oatomobile_torch.baselines.learned import common
from oatomobile_torch.models.dim import CONTEXT_KEYS, ImitativeModel


def dim_plan(model: ImitativeModel, inputs: Mapping[str, torch.Tensor],
             num_steps: int) -> torch.Tensor:
  """The plan [1, T, 2] from a ``CapturedAct``'s inputs (the raw
  observation's model keys, ``lr`` and ``epsilon``)."""
  sample = model.transform(inputs)
  context = common.model_context(sample, CONTEXT_KEYS)
  with torch.no_grad():
    return model.plan(num_steps=num_steps, goal=sample.get("goal"),
                      lr=inputs["lr"], epsilon=inputs["epsilon"], **context)


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
    self._plan = common.CapturedAct(functools.partial(dim_plan, model),
                                    next(model.parameters()).device)

  def __call__(self, observation: Mapping[str, np.ndarray],
               **kwargs) -> np.ndarray:
    obs = common.prepare_observation(observation)
    plan = self._plan(
        common.act_inputs(obs, lr=kwargs.get("lr", 5e-2),
                          epsilon=kwargs.get("epsilon", 1.0)),
        num_steps=kwargs.get("num_steps", 20))
    return common.interpolate_plan(plan)  # [T, 2] -> 3D
