"""Base agent interface: a copy of the JAX package's ``core/agent.py``."""

import abc
from typing import Any

from oatomobile_torch.core.rl import Env
from oatomobile_torch.core.simulator import Action, Observations


class Agent(abc.ABC):
  """An agent consists of an action-selection mechanism and an update rule."""

  def __init__(self, environment: Env, *args: Any, **kwargs: Any) -> None:
    self._environment = environment

  @abc.abstractmethod
  def act(self, observations: Observations) -> Action:
    """Samples an action from the agent's policy, given observations."""

  def update(
      self,
      observations: Observations,
      action: Action,
      new_observations: Observations,
  ) -> None:
    """Updates the agent given a transition (no-op by default)."""
    del observations, action, new_observations
