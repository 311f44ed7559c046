"""The blind agent: drives straight to the goals, ignoring perception (a
copy of the JAX package's ``baselines/rulebased/blind/agent.py``: the plan
is the goal waypoints)."""

import numpy as np

import oatomobile_torch
from oatomobile_torch.baselines.base import SetPointAgent


class BlindAgent(SetPointAgent):
  """Uses the goal sensor's waypoints directly as the plan."""

  def __call__(self, observation: oatomobile_torch.Observations, *args,
               **kwargs) -> np.ndarray:
    return np.asarray(observation["goal"])
