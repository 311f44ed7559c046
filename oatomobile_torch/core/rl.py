"""Core gym-style API for environments, metrics and wrappers: a copy of the
JAX package's ``core/rl.py``.

gym is not a dependency; ``Env``/``Wrapper`` provide the same interface
surface (reset/step/render/close, observation_space/action_space,
``unwrapped``).  ``MonitorWrapper`` writes GIFs through ``imageio`` and
``LiveViewWrapper`` shows frames through ``utils.graphics.LiveViewer``;
both import them when they are built, not with this module.
"""

import abc
from typing import Any, Callable, Mapping, Tuple

import numpy as np

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
  """Records a video (GIF) of the episode."""

  def __init__(self,
               env: Env,
               *,
               output_fname: str,
               downsample_factor: int = 1,
               render_mode: str = "rgb_array",
               record_every: int = 1) -> None:
    """``render_mode="human"`` records the multi-panel dashboard
    (camera + bird view + LIDAR + HUD) instead of the bird view;
    ``record_every=N`` keeps every Nth frame (20 Hz sim -> 20/N Hz gif)."""
    super().__init__(env=env)
    import imageio  # pylint: disable=import-outside-toplevel
    self._output_fname = output_fname
    self._downsample_factor = downsample_factor
    self._render_mode = render_mode
    self._record_every = max(1, int(record_every))
    self._frame_count = 0
    self._recorder = imageio.get_writer(self._output_fname, mode="I")

  def reset(self, *args: Any, **kwargs: Any) -> Observations:
    observation = self.env.reset(*args, **kwargs)
    self._record_frame()
    return observation

  def step(self, action: Action, *args: Any, **kwargs: Any) -> Transition:
    observation, reward, done, info = self.env.step(action)
    self._record_frame()
    return observation, reward, done, info

  def _record_frame(self) -> None:
    self._frame_count += 1
    if (self._frame_count - 1) % self._record_every:
      return
    frame = np.asarray(self.render(mode=self._render_mode))
    factor = self._downsample_factor
    if factor > 1:
      frame = frame[::factor, ::factor]
    if frame.dtype != np.uint8:
      frame = (np.clip(frame, 0.0, 1.0) * 255).astype(np.uint8)
    self._recorder.append_data(frame)

  def close(self) -> None:
    # Flush the video before closing the env: imageio writers only write
    # the file on close.
    self._recorder.close()
    self.env.close()


class LiveViewWrapper(Wrapper):
  """Displays the multi-panel dashboard live while the episode runs, the
  role of the reference's pygame window.  Headless hosts degrade to a
  no-op (see ``utils.graphics.LiveViewer``)."""

  def __init__(self, env: Env, *, refresh_hz: float = 5.0,
               render_mode: str = "human") -> None:
    super().__init__(env=env)
    from oatomobile_torch.utils.graphics import LiveViewer  # pylint: disable=import-outside-toplevel
    self._viewer = LiveViewer(refresh_hz=refresh_hz)
    self._render_mode = render_mode

  def _show(self) -> None:
    frame = np.asarray(self.render(mode=self._render_mode))
    if frame.dtype != np.uint8:
      frame = (np.clip(frame, 0.0, 1.0) * 255).astype(np.uint8)
    self._viewer.show(frame)

  def reset(self, *args: Any, **kwargs: Any) -> Observations:
    observation = self.env.reset(*args, **kwargs)
    self._show()
    return observation

  def step(self, action: Action, *args: Any, **kwargs: Any) -> Transition:
    transition = self.env.step(action)
    self._show()
    return transition

  def close(self) -> None:
    self._viewer.close()
    self.env.close()
