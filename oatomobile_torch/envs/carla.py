"""Gym wrapper of the single-scene simulator: the user-facing driving
environment.  A copy of the JAX package's ``envs/carla.py`` over the
port's ``CUDASimulator`` (``CARLAEnv``, ``CARLANavEnv``, the CARLA metrics
and the terminate-on-X wrappers); the class names are the reference's.
"""

import logging
from typing import Any, Optional, Sequence, Union

import numpy as np

from oatomobile_torch.core.registry import registry
from oatomobile_torch.core.rl import Env, Metric, Transition, Wrapper
from oatomobile_torch.simulators.cuda import defaults
from oatomobile_torch.simulators.cuda.simulator import CUDASimulator
from oatomobile_torch.utils import spaces

logger = logging.getLogger(__name__)


class CARLAEnv(Env):
  """The driving environment: the port's world, one scene, under a gym
  API.  ``device`` (among ``sim_kwargs``) is where the scene lives:
  ``"cuda"`` unless the caller asks for ``"cpu"``."""

  def __init__(
      self,
      *,
      town: str,
      spawn_point: Optional[int] = None,
      destination: Optional[int] = None,
      fps: int = defaults.SIMULATOR_FPS,
      sensors: Sequence[str] = defaults.CARLA_SENSORS,
      num_vehicles: int = 0,
      num_pedestrians: int = 0,
      **sim_kwargs: Any) -> None:
    # Mandatory core sensors (reference envs/carla.py:69-81).
    _sensors = set([
        "collision",
        "lane_invasion",
        "location",
        "rotation",
        "control",
        "predictions",
    ])
    for sensor in sensors:
      if registry.get_sensor(sensor) is not None:
        _sensors.add(sensor)
    _sensors = sorted(_sensors)

    super().__init__(
        sim_fn=CUDASimulator,
        town=town,
        sensors=_sensors,
        fps=fps,
        spawn_point=spawn_point,
        destination=destination,
        num_vehicles=num_vehicles,
        num_pedestrians=num_pedestrians,
        **sim_kwargs,
    )

  @property
  def action_space(self) -> spaces.Dict:
    """(reference envs/carla.py:96-118)."""
    return spaces.Dict(
        throttle=spaces.Box(low=0.0, high=1.0, shape=(), dtype=np.float32),
        steer=spaces.Box(low=-1.0, high=1.0, shape=(), dtype=np.float32),
        brake=spaces.Box(low=0.0, high=1.0, shape=(), dtype=np.float32),
    )


class CARLANavEnv(CARLAEnv):
  """Navigation environment: done + reward on reaching the destination
  (reference envs/carla.py:121-186)."""

  def __init__(
      self,
      *,
      town: str,
      origin: Union[int, Sequence[float]],
      destination: Union[int, Sequence[float]],
      fps: int = defaults.SIMULATOR_FPS,
      sensors: Sequence[str] = defaults.CARLA_SENSORS,
      num_vehicles: int = 0,
      num_pedestrians: int = 0,
      proximity_destination_threshold: float = 7.5,
      **sim_kwargs: Any) -> None:
    super().__init__(
        town=town,
        spawn_point=origin,
        destination=destination,
        fps=fps,
        sensors=sensors,
        num_vehicles=num_vehicles,
        num_pedestrians=num_pedestrians,
        **sim_kwargs,
    )
    self._proximity_destination_threshold = proximity_destination_threshold

  def step(self, action: Any) -> Transition:
    observation, reward, done, info = super().step(action)
    if not done:
      destination = self.simulator.destination
      current_location = observation["location"]
      destination_location = np.asarray(
          [destination.location.x, destination.location.y,
           destination.location.z], dtype=np.float32)
      distance_to_go = np.linalg.norm(current_location -
                                      destination_location)
      done = bool(distance_to_go < self._proximity_destination_threshold)
      reward = float(done)
    return observation, reward, done, info


class LaneInvasionsMetric(Metric):
  """Counts lane invasions in an episode (envs/carla.py:189-205)."""

  def __init__(self, *args: Any, **kwargs: Any) -> None:
    super().__init__(initial_value=0)

  def _get_uuid(self, *args: Any, **kwargs: Any) -> str:
    return "lane_invasions"

  def update(self, observations, action, reward, new_observations, *args,
             **kwargs) -> None:
    if new_observations["lane_invasion"] > 0:
      self.value += 1


class TerminateOnLaneInvasionWrapper(Wrapper):
  """Terminates episode on lane invasion (envs/carla.py:208-222)."""

  def step(self, action: Any, *args: Any, **kwargs: Any) -> Transition:
    observation, reward, done, info = self.env.step(action)
    if observation["lane_invasion"] > 0:
      logger.debug("A lane was invaded")
      done = True
      reward = -1.0
    return observation, reward, done, info


class CollisionsMetric(Metric):
  """Counts collisions in an episode (envs/carla.py:225-241)."""

  def __init__(self, *args: Any, **kwargs: Any) -> None:
    super().__init__(initial_value=0)

  def _get_uuid(self, *args: Any, **kwargs: Any) -> str:
    return "collisions"

  def update(self, observations, action, reward, new_observations, *args,
             **kwargs) -> None:
    if new_observations["collision"] > 0:
      self.value += 1


class TerminateOnCollisionWrapper(Wrapper):
  """Terminates episode on collision (envs/carla.py:244-258)."""

  def step(self, action: Any, *args: Any, **kwargs: Any) -> Transition:
    observation, reward, done, info = self.env.step(action)
    if observation["collision"] > 0:
      logger.debug("A collision occured")
      done = True
      reward = -1.0
    return observation, reward, done, info


class DistanceMetric(Metric):
  """Accumulates travelled Euclidean distance (envs/carla.py:261-280)."""

  def __init__(self, *args: Any, **kwargs: Any) -> None:
    super().__init__(initial_value=0.0)

  def _get_uuid(self, *args: Any, **kwargs: Any) -> str:
    return "distance"

  def update(self, observations, action, reward, new_observations, *args,
             **kwargs) -> None:
    self.value += float(
        np.linalg.norm(new_observations["location"] -
                       observations["location"]))
