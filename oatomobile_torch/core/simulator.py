"""Core APIs to interface with simulators: a copy of the JAX package's
``core/simulator.py``.

The ``Sensor`` / ``Observations`` / ``SensorSuite`` / ``Simulator``
contracts of the reference API.  Sensors are views into a world state
that lives on a device (their values are synthesised with the world
step), not asynchronous queue readers: ``get_observation`` returns an
already-materialised value.
"""

import abc
from enum import Enum
from typing import Any, Iterable, Mapping

from oatomobile_torch.utils import spaces

# All agents are expected to return the same action type.
Action = Any

# Enumeration of types of sensors.
SensorTypes = Enum


class Sensor(abc.ABC):
  """A sensor consists of a fetching mechanism for observations."""

  def __init__(self, *args: Any, **kwargs: Any) -> None:
    self.uuid = self._get_uuid(*args, **kwargs)
    self.sensor_type = self._get_sensor_type(*args, **kwargs)

  @abc.abstractmethod
  def _get_uuid(self, *args: Any, **kwargs: Any) -> str:
    """Returns the universal unique identifier of the sensor."""

  @abc.abstractmethod
  def _get_sensor_type(self, *args: Any, **kwargs: Any) -> SensorTypes:
    """Returns the type of the sensor."""

  @property
  @abc.abstractmethod
  def observation_space(self) -> spaces.Space:
    """Returns the observation spec of the sensor."""

  @abc.abstractmethod
  def get_observation(self, *args: Any, **kwargs: Any) -> Any:
    """Retrieves the observation from the sensor."""

  def close(self) -> None:
    """Destroys the sensor.  No server connections exist in this backend."""

  @classmethod
  def default(cls, *args: Any, **kwargs: Any) -> "Sensor":
    """Returns the default sensor instance."""
    return cls(*args, **kwargs)


class Observations(dict):
  """Dictionary containing sensor observations."""

  def __init__(self, sensors: Mapping[str, Sensor], *args: Any,
               **kwargs: Any) -> None:
    data = [(uuid, sensor.get_observation(*args, **kwargs))
            for uuid, sensor in sensors.items()]
    super().__init__(data)


class SensorSuite:
  """A set of sensors, each identified by a unique id."""

  def __init__(self, sensors: Iterable[Sensor]) -> None:
    self.sensors = dict()
    self._observation_space = dict()
    for sensor in sensors:
      if sensor.uuid in self.sensors:
        raise KeyError("{} is duplicated sensor uuid".format(sensor.uuid))
      self.sensors[sensor.uuid] = sensor
      self._observation_space[sensor.uuid] = sensor.observation_space

  def get(self, uuid: str) -> Sensor:
    return self.sensors.get(uuid)

  def get_observations(self, *args: Any, **kwargs: Any) -> Observations:
    return Observations(self.sensors, *args, **kwargs)

  @property
  def observation_space(self) -> spaces.Dict:
    return spaces.Dict({
        sensor.uuid: sensor.observation_space
        for sensor in self.sensors.values()
    })

  def close(self) -> None:
    for sensor in self.sensors.values():
      sensor.close()


class Simulator(abc.ABC):
  """Basic simulator contract."""

  @property
  @abc.abstractmethod
  def sensor_suite(self) -> SensorSuite:
    """Returns a reference to the suite of sensors."""

  @abc.abstractmethod
  def action_space(self) -> Any:
    """Returns the specification of the actions expected by the simulator."""

  @property
  def observation_space(self) -> spaces.Dict:
    return self.sensor_suite.observation_space

  @abc.abstractmethod
  def seed(self, seed: int) -> None:
    """Fixes the random number generator state."""

  @abc.abstractmethod
  def reset(self, *args: Any, **kwargs: Any) -> Observations:
    """Resets the state of the simulation to the initial state."""

  @abc.abstractmethod
  def step(self, action: Action, *args: Any, **kwargs: Any) -> Observations:
    """Makes a step in the simulator, provided an action."""

  @abc.abstractmethod
  def render(self, mode: str = "rgb_array", *args: Any, **kwargs: Any) -> Any:
    """Renders current state of the simulator."""

  @abc.abstractmethod
  def close(self) -> None:
    """Closes the simulator."""
