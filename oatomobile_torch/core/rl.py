"""Core gym-style API for environments, metrics and wrappers: a copy of the
JAX package's ``core/rl.py``.

gym is not a dependency; ``Env``/``Wrapper`` provide the same interface
surface (reset/step/render/close, observation_space/action_space,
``unwrapped``).  ``MonitorWrapper`` and ``LiveViewWrapper`` need
``utils/graphics`` and the dashboard render, which are not ported yet:
they raise ``NotImplementedError``.
"""

import abc
from typing import Any, Callable, Mapping, Tuple

from oatomobile_torch.core.dataset import Episode, tokens
from oatomobile_torch.core.simulator import Action, Observations, Simulator
from oatomobile_torch.utils import spaces

# OpenAI Gym transition.
Transition = Tuple[Observations, float, bool, Mapping[str, Any]]


class Env:
  """Fundamental environment class implementing the OpenAI Gym interface,
  wrapping a driving simulator."""

  # gym API compatibility attributes.
  metadata = {"render.modes": ["human", "rgb_array"]}
  reward_range = (-float("inf"), float("inf"))

  def __init__(self, sim_fn: Callable[..., Simulator], *args: Any,
               **kwargs: Any) -> None:
    self._sim = sim_fn(*args, **kwargs)
    self._reset_next_step = True

  @property
  def simulator(self) -> Simulator:
    return self._sim

  @property
  def unwrapped(self) -> "Env":
    return self

  @property
  def observation_space(self) -> spaces.Dict:
    return self.simulator.observation_space

  @property
  def action_space(self) -> spaces.Space:
    return self.simulator.action_space()

  def seed(self, seed: int) -> None:
    self.simulator.seed(seed)

  def reset(self, *args: Any, **kwargs: Any) -> Observations:
    self._reset_next_step = False
    return self.simulator.reset(*args, **kwargs)

  def step(self, action: Action, *args: Any, **kwargs: Any) -> Transition:
    if self._reset_next_step:
      return self.reset()
    observation = self.simulator.step(action, *args, **kwargs)
    # Reward/done stubs, as in the reference (core/rl.py:83-86).
    reward = 0.0
    done = False
    info = dict()
    return observation, reward, done, info

  def render(self, mode: str = "human", *args: Any, **kwargs: Any) -> Any:
    return self.simulator.render(mode=mode, *args, **kwargs)

  def close(self) -> None:
    self.simulator.close()


class Wrapper(Env):
  """gym.Wrapper-compatible base class (composition over inheritance)."""

  def __init__(self, env: Env) -> None:  # pylint: disable=super-init-not-called
    self.env = env

  def __getattr__(self, name: str) -> Any:
    # Delegates unknown attributes to the wrapped env (gym semantics).
    if name.startswith("_"):
      raise AttributeError(name)
    return getattr(self.env, name)

  @property
  def simulator(self) -> Simulator:
    return self.env.simulator

  @property
  def unwrapped(self) -> Env:
    return self.env.unwrapped

  @property
  def observation_space(self) -> spaces.Dict:
    return self.env.observation_space

  @property
  def action_space(self) -> spaces.Space:
    return self.env.action_space

  def seed(self, seed: int) -> None:
    self.env.seed(seed)

  def reset(self, *args: Any, **kwargs: Any) -> Observations:
    return self.env.reset(*args, **kwargs)

  def step(self, action: Action, *args: Any, **kwargs: Any) -> Transition:
    return self.env.step(action, *args, **kwargs)

  def render(self, mode: str = "human", *args: Any, **kwargs: Any) -> Any:
    return self.env.render(mode=mode, *args, **kwargs)

  def close(self) -> None:
    self.env.close()


class Metric(abc.ABC):
  """Stateful evaluation metric accumulated by the environment loop."""

  def __init__(self, initial_value: float, *args: Any, **kwargs: Any) -> None:
    self._initial_value = initial_value
    self.value = self._initial_value
    self.uuid = self._get_uuid(*args, **kwargs)

  def __repr__(self) -> str:
    return "{}: {}".format(self.uuid, self.value)

  def reset(self) -> None:
    self.value = self._initial_value

  @abc.abstractmethod
  def _get_uuid(self, *args: Any, **kwargs: Any) -> str:
    """Returns the universal unique identifier of the metric."""

  @abc.abstractmethod
  def update(self, observations: Observations, action: Action, reward: float,
             new_observations: Observations, *args: Any,
             **kwargs: Any) -> None:
    """Records transition and updates evaluation."""


class StepsMetric(Metric):
  """Counts the number of steps in an environment."""

  def __init__(self, *args: Any, **kwargs: Any) -> None:
    super().__init__(initial_value=0)

  def _get_uuid(self, *args: Any, **kwargs: Any) -> str:
    return "steps"

  def update(self, observations, action, reward, new_observations, *args,
             **kwargs) -> None:
    self.value += 1


class ReturnsMetric(Metric):
  """Accumulates undiscounted rewards in an episode."""

  def __init__(self, *args: Any, **kwargs: Any) -> None:
    super().__init__(initial_value=0.0)

  def _get_uuid(self, *args: Any, **kwargs: Any) -> str:
    return "returns"

  def update(self, observations, action, reward, new_observations, *args,
             **kwargs) -> None:
    self.value += reward


class FiniteHorizonWrapper(Wrapper):
  """Terminates simulation after a specified number of steps."""

  def __init__(self, env: Env, *, max_episode_steps: int) -> None:
    super().__init__(env=env)
    self._max_episode_steps = int(max_episode_steps)
    self._episode_step = 0

  def reset(self, *args: Any, **kwargs: Any) -> Observations:
    self._episode_step = 0
    return self.env.reset(*args, **kwargs)

  def step(self, action: Action, *args: Any, **kwargs: Any) -> Transition:
    observation, reward, done, info = self.env.step(action)
    self._episode_step += 1
    if self._episode_step >= self._max_episode_steps:
      done = True
    return observation, reward, done, info


class SaveToDiskWrapper(Wrapper):
  """Stores observations to disk as an ``Episode``."""

  def __init__(self, env: Env, *, output_dir: str) -> None:
    super().__init__(env=env)
    self._output_dir = output_dir
    self._episode = None

  def reset(self, *args: Any, **kwargs: Any) -> Observations:
    self._episode = Episode(self._output_dir, next(tokens))
    observation = self.env.reset(*args, **kwargs)
    self._episode.append(**observation)
    return observation

  def step(self, action: Action, *args: Any, **kwargs: Any) -> Transition:
    observation, reward, done, info = self.env.step(action)
    self._episode.append(**observation)
    return observation, reward, done, info


class MonitorWrapper(Wrapper):
  """Records a video (GIF) of the episode.  Not ported yet: it needs
  ``imageio`` and the dashboard render of ``utils/graphics``."""

  def __init__(self, env: Env, **kwargs: Any) -> None:
    del env, kwargs
    raise NotImplementedError(
        "MonitorWrapper is not ported to oatomobile_torch yet: it needs "
        "imageio and oatomobile_torch.utils.graphics")


class LiveViewWrapper(Wrapper):
  """Displays the dashboard live while the episode runs.  Not ported yet:
  it needs ``utils/graphics``."""

  def __init__(self, env: Env, **kwargs: Any) -> None:
    del env, kwargs
    raise NotImplementedError(
        "LiveViewWrapper is not ported to oatomobile_torch yet: it needs "
        "oatomobile_torch.utils.graphics")
