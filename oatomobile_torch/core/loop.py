"""The episode loop, Acme-inspired: a copy of the JAX package's
``core/loop.py``.

Exceptions are not swallowed: they propagate after the environment is
closed.  Pass ``swallow_exceptions=True`` for the reference's behaviour.
"""

import logging
from typing import Callable, Mapping, Optional, Sequence

from oatomobile_torch import types
from oatomobile_torch.core.agent import Agent
from oatomobile_torch.core.rl import Env, Metric

logger = logging.getLogger(__name__)


class EnvironmentLoop:
  """Coordinates an `Env` and an `Agent`:

    loop = EnvironmentLoop(agent_fn, environment)
    loop.run()
  """

  def __init__(
      self,
      agent_fn: Callable[..., Agent],
      environment: Env,
      metrics: Optional[Sequence[Metric]] = None,
      render_mode: str = "none",
      swallow_exceptions: bool = False,
  ) -> None:
    assert render_mode in ("none", "human", "rgb_array")
    self._agent_fn = agent_fn
    self._environment = environment
    self._metrics = metrics
    self._render_mode = render_mode
    self._swallow_exceptions = swallow_exceptions

  def run(self) -> Optional[Mapping[str, types.Scalar]]:
    """Performs the run loop: reset -> act -> step -> update -> metrics."""
    try:
      done = False
      observation = self._environment.reset()
      if self._render_mode != "none":
        self._environment.render(mode=self._render_mode)
      agent = self._agent_fn(environment=self._environment)

      while not done:
        action = agent.act(observation)
        new_observation, reward, done, _ = self._environment.step(action)
        if self._render_mode != "none":
          self._environment.render(mode=self._render_mode)
        agent.update(observation, action, new_observation)
        if self._metrics is not None:
          for metric in self._metrics:
            metric.update(observation, action, reward, new_observation)
        observation = new_observation

    except Exception as msg:  # pylint: disable=broad-except
      logger.error(msg)
      if not self._swallow_exceptions:
        raise

    finally:
      try:
        self._environment.close()
      except Exception:  # pylint: disable=broad-except
        pass

    if self._metrics is not None:
      return {metric.uuid: metric.value for metric in self._metrics}
    return None
