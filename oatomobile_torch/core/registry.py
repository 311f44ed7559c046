"""Central component registry (Habitat-style): a copy of the JAX package's
``core/registry.py``.  The port's registry is its own: the single-scene
simulator of this package registers as ``"carla"`` here."""

import collections
import logging
from typing import Optional

from oatomobile_torch import types

logger = logging.getLogger(__name__)


class Registry(metaclass=types.Singleton):
  """The singleton registry object: name -> class for simulators, sensors
  and environments."""

  mapping = collections.defaultdict(dict)

  @classmethod
  def _register_impl(cls, _type, to_register, name, assert_type=None):

    def wrap(to_register):
      if assert_type is not None:
        assert issubclass(to_register, assert_type), (
            "{} must be a subclass of {}".format(to_register, assert_type))
      register_name = to_register.__name__ if name is None else name
      logger.debug("Registers %s at %s", register_name, _type)
      cls.mapping[_type][register_name] = to_register
      return to_register

    if to_register is None:
      return wrap
    return wrap(to_register)

  @classmethod
  def _get_impl(cls, _type, name):
    return cls.mapping[_type].get(name, None)

  @classmethod
  def register_simulator(cls, to_register=None, name: Optional[str] = None):
    """Registers a simulator with key ``name``."""
    from oatomobile_torch.core.simulator import Simulator
    return cls._register_impl("simulators", to_register, name,
                              assert_type=Simulator)

  @classmethod
  def register_sensor(cls, to_register=None, name: Optional[str] = None):
    """Registers a sensor with key ``name``."""
    from oatomobile_torch.core.simulator import Sensor
    return cls._register_impl("sensors", to_register, name,
                              assert_type=Sensor)

  @classmethod
  def register_env(cls, to_register=None, name: Optional[str] = None):
    """Registers an environment with key ``name``."""
    from oatomobile_torch.core.rl import Env
    return cls._register_impl("envs", to_register, name, assert_type=Env)

  @classmethod
  def get_simulator(cls, name: str):
    return cls._get_impl("simulators", name)

  @classmethod
  def get_sensor(cls, name: str):
    return cls._get_impl("sensors", name)

  @classmethod
  def get_env(cls, name: str):
    return cls._get_impl("envs", name)


# The singleton registry instance.
registry = Registry()
