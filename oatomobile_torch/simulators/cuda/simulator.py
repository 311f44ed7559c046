"""The single-scene simulator on a CUDA device: the reference's CARLA API
over the port's batched world, at a batch of one.

The counterpart of the JAX package's ``TPUSimulator``
(``simulators/tpu/simulator.py``), registered under the same name,
``"carla"``.  ``reset`` builds one scene with ``init_scene`` and runs the
warm-up's zero-action world steps; ``step`` is one ``world_step`` and one
``synthesize`` of the requested sensors on the scene batch of one, whose
values are then copied to the host with the batch axis dropped.  With
``"lidar"`` among the sensors (the default) each ``reset`` and each
``step`` launches the BEV splat kernel once on a card.

The JAX simulator jits its fused step with the state donated and scans
its warm-up.  Here the scene lives in static buffers from the first
``reset`` on (``reset`` copies each new scene into them), and the step and
the warm-up step run through ``graphs.CapturedStep``: on a card each is
captured into a CUDA graph and replayed (the warm-up ``warmup_steps``
times), on the CPU each runs eagerly.  The step reads the action from a
static ``[1, 3]`` buffer.

The sensor zoo of the reference maps to lightweight host-side ``Sensor``
shells that hold the materialised observation values.
"""

import enum
from typing import Any, Mapping, Optional, Sequence

import numpy as np
import torch

from oatomobile_torch import device as device_lib
from oatomobile_torch import graphs
from oatomobile_torch.core.registry import registry
from oatomobile_torch.core.simulator import (Observations, Sensor, SensorSuite,
                                             Simulator)
from oatomobile_torch.maps import load_town
from oatomobile_torch.sensors import synth
from oatomobile_torch.sim import init_scene, make_params, world_step
from oatomobile_torch.sim.types import clone_state, copy_state_
from oatomobile_torch.simulators.cuda import defaults
from oatomobile_torch.utils import spaces


class CARLASensorTypes(enum.Enum):
  """Sensor type ids (parity: simulator.py:47-73)."""
  FRONT_CAMERA_RGB = 0
  BIRD_VIEW_CAMERA_RGB = 1
  LIDAR = 2
  CONTROL = 3
  LOCATION = 4
  ROTATION = 5
  VELOCITY = 6
  ACCELERATION = 7
  ORIENTATION = 8
  ANGULAR_VELOCITY = 9
  SPEED_LIMIT = 10
  IS_AT_TRAFFIC_LIGHT = 11
  TRAFFIC_LIGHT_STATE = 12
  COLLISION = 13
  LANE_INVASION = 14
  BIRD_VIEW_CAMERA_CITYSCAPES = 15
  GOAL = 16
  PREDICTIONS = 17
  ACTORS_TRACKER = 18
  GAME_STATE = 19
  REAR_CAMERA_RGB = 20
  LEFT_CAMERA_RGB = 21
  RIGHT_CAMERA_RGB = 22
  RED_LIGHT_INVASION = 23


class CARLAAction:
  """Vehicle control, mirroring ``carla.VehicleControl`` observables."""

  __slots__ = ("throttle", "steer", "brake", "hand_brake", "reverse")

  def __init__(self, throttle: float = 0.0, steer: float = 0.0,
               brake: float = 0.0, hand_brake: bool = False,
               reverse: bool = False) -> None:
    self.throttle = float(throttle)
    self.steer = float(steer)
    self.brake = float(brake)
    self.hand_brake = bool(hand_brake)
    self.reverse = bool(reverse)

  def as_array(self) -> np.ndarray:
    return np.asarray([self.throttle, self.steer, self.brake],
                      dtype=np.float32)

  def __repr__(self) -> str:
    return "CARLAAction(throttle={:.3f}, steer={:.3f}, brake={:.3f})".format(
        self.throttle, self.steer, self.brake)


def _to_action_array(action: Any) -> np.ndarray:
  if action is None:
    return np.zeros(3, dtype=np.float32)
  if isinstance(action, CARLAAction):
    return action.as_array()
  if isinstance(action, Mapping):
    return np.asarray([
        float(np.asarray(action.get("throttle", 0.0))),
        float(np.asarray(action.get("steer", 0.0))),
        float(np.asarray(action.get("brake", 0.0))),
    ], dtype=np.float32)
  arr = np.asarray(action, dtype=np.float32).reshape(-1)
  out = np.zeros(3, dtype=np.float32)
  out[:min(3, arr.size)] = arr[:3]
  return out


# ---------------------------------------------------------------------------
# Sensor shells
# ---------------------------------------------------------------------------


class DeviceSensor(Sensor):
  """A sensor whose observation is synthesised on the device by the
  simulator's step; `get_observation` just returns the materialised
  value."""

  UUID: str = ""
  SENSOR_TYPE: CARLASensorTypes = None
  SPACE: spaces.Space = None

  def __init__(self, *args: Any, **kwargs: Any) -> None:
    del args, kwargs
    super().__init__()
    self._value = None

  def _get_uuid(self, *args: Any, **kwargs: Any) -> str:
    return self.UUID

  def _get_sensor_type(self, *args: Any, **kwargs: Any) -> CARLASensorTypes:
    return self.SENSOR_TYPE

  @property
  def observation_space(self) -> spaces.Space:
    return self.SPACE

  def set_value(self, value: np.ndarray) -> None:
    self._value = value

  def get_observation(self, *args: Any, **kwargs: Any) -> np.ndarray:
    return self._value

  @classmethod
  def default(cls, *args, **kwargs) -> "DeviceSensor":
    return cls()


def _device_sensor(uuid: str, sensor_type: CARLASensorTypes,
                   space: spaces.Space):
  """Declares + registers a DeviceSensor subclass for `uuid`."""
  cls = type(
      "Sensor_{}".format(uuid),
      (DeviceSensor,),
      {"UUID": uuid, "SENSOR_TYPE": sensor_type, "SPACE": space},
  )
  registry.register_sensor(cls, name=uuid)
  return cls


_BOX3 = spaces.Box(low=-np.inf, high=np.inf, shape=(3,), dtype=np.float32)

# State readouts (reference classes at simulator.py:441-971).
ControlSensor = _device_sensor(
    "control", CARLASensorTypes.CONTROL,
    spaces.Box(low=np.asarray([0.0, -1.0, 0.0]),
               high=np.asarray([1.0, 1.0, 1.0]), dtype=np.float32))
LocationSensor = _device_sensor("location", CARLASensorTypes.LOCATION, _BOX3)
RotationSensor = _device_sensor("rotation", CARLASensorTypes.ROTATION, _BOX3)
VelocitySensor = _device_sensor("velocity", CARLASensorTypes.VELOCITY, _BOX3)
AccelerationSensor = _device_sensor("acceleration",
                                    CARLASensorTypes.ACCELERATION, _BOX3)
OrientationSensor = _device_sensor("orientation",
                                   CARLASensorTypes.ORIENTATION, _BOX3)
AngularVelocitySensor = _device_sensor("angular_velocity",
                                       CARLASensorTypes.ANGULAR_VELOCITY,
                                       _BOX3)
SpeedLimitSensor = _device_sensor(
    "speed_limit", CARLASensorTypes.SPEED_LIMIT,
    spaces.Box(low=0.0, high=np.inf, shape=(), dtype=np.float32))
IsAtTrafficLightSensor = _device_sensor("is_at_traffic_light",
                                        CARLASensorTypes.IS_AT_TRAFFIC_LIGHT,
                                        spaces.Discrete(2))
TrafficLightStateSensor = _device_sensor("traffic_light_state",
                                         CARLASensorTypes.TRAFFIC_LIGHT_STATE,
                                         spaces.Discrete(5))
CollisionSensor = _device_sensor(
    "collision", CARLASensorTypes.COLLISION,
    spaces.Box(low=0.0, high=np.inf, shape=(), dtype=np.float32))
LaneInvasionSensor = _device_sensor(
    "lane_invasion", CARLASensorTypes.LANE_INVASION,
    spaces.Box(low=0.0, high=np.inf, shape=(), dtype=np.float32))
GoalSensor = _device_sensor(
    "goal", CARLASensorTypes.GOAL,
    spaces.Box(low=-np.inf, high=np.inf,
               shape=(defaults.GOAL_SENSOR_CONFIG["num_goals"], 3),
               dtype=np.float32))
LIDARSensor = _device_sensor(
    "lidar", CARLASensorTypes.LIDAR,
    spaces.Box(low=0.0, high=1.0,
               shape=(defaults.LIDAR_IMAGE_SIZE, defaults.LIDAR_IMAGE_SIZE, 2),
               dtype=np.float32))
BirdViewCameraRGBSensor = _device_sensor(
    "bird_view_camera_rgb", CARLASensorTypes.BIRD_VIEW_CAMERA_RGB,
    spaces.Box(low=0.0, high=1.0,
               shape=(defaults.BIRD_VIEW_IMAGE_SIZE,
                      defaults.BIRD_VIEW_IMAGE_SIZE, 3), dtype=np.float32))
BirdViewCameraCityScapesSensor = _device_sensor(
    "bird_view_camera_cityscapes",
    CARLASensorTypes.BIRD_VIEW_CAMERA_CITYSCAPES,
    spaces.Box(low=0.0, high=1.0,
               shape=(defaults.BIRD_VIEW_IMAGE_SIZE,
                      defaults.BIRD_VIEW_IMAGE_SIZE, 3), dtype=np.float32))
ActorsTrackerSensor = _device_sensor(
    "actors_tracker", CARLASensorTypes.ACTORS_TRACKER,
    spaces.Box(low=-np.inf, high=np.inf, shape=(0, 4), dtype=np.float32))

_CAMERA_BOX = spaces.Box(
    low=0.0, high=1.0,
    shape=(defaults.FRONT_CAMERA_IMAGE_SIZE[0],
           defaults.FRONT_CAMERA_IMAGE_SIZE[1], 3), dtype=np.float32)
FrontCameraRGBSensor = _device_sensor(
    "front_camera_rgb", CARLASensorTypes.FRONT_CAMERA_RGB, _CAMERA_BOX)
RearCameraRGBSensor = _device_sensor(
    "rear_camera_rgb", CARLASensorTypes.REAR_CAMERA_RGB, _CAMERA_BOX)
LeftCameraRGBSensor = _device_sensor(
    "left_camera_rgb", CARLASensorTypes.LEFT_CAMERA_RGB, _CAMERA_BOX)
RightCameraRGBSensor = _device_sensor(
    "right_camera_rgb", CARLASensorTypes.RIGHT_CAMERA_RGB, _CAMERA_BOX)
GameStateSensor = _device_sensor(
    "game_state", CARLASensorTypes.GAME_STATE,
    spaces.Box(low=0, high=1, shape=(320, 320, 8), dtype=np.int32))
# Implemented here; the reference registered it but left it unimplemented
# (simulator.py:1409-1472).
RedLightInvasionSensor = _device_sensor(
    "red_light_invasion", CARLASensorTypes.RED_LIGHT_INVASION,
    spaces.Discrete(2))


@registry.register_sensor(name="predictions")
class PredictionsSensor(Sensor):
  """Write-back channel used by agents to expose plans for rendering
  (parity: simulator.py:1337-1406)."""

  def __init__(self, *args: Any, **kwargs: Any) -> None:
    del args, kwargs
    super().__init__()
    self._predictions = None

  def _get_uuid(self, *args, **kwargs) -> str:
    return "predictions"

  def _get_sensor_type(self, *args, **kwargs) -> CARLASensorTypes:
    return CARLASensorTypes.PREDICTIONS

  @property
  def observation_space(self) -> spaces.Space:
    return spaces.Box(low=-np.inf, high=np.inf, shape=(4, 2),
                      dtype=np.float32)

  @property
  def predictions(self) -> np.ndarray:
    return self._predictions

  @predictions.setter
  def predictions(self, value: np.ndarray) -> None:
    self._predictions = value

  def get_observation(self, *args, **kwargs) -> np.ndarray:
    return self._predictions

  @classmethod
  def default(cls, *args, **kwargs) -> "PredictionsSensor":
    return cls()


# Sensor keys that are synthesised on the device with each step.
_DEVICE_KEYS = frozenset(synth.STATE_SENSORS) | {
    "lidar", "bird_view_camera_rgb", "bird_view_camera_cityscapes",
    "actors_tracker", "game_state", "front_camera_rgb", "rear_camera_rgb",
    "left_camera_rgb", "right_camera_rgb", "red_light_invasion"
}


# ---------------------------------------------------------------------------
# Simulator
# ---------------------------------------------------------------------------


@registry.register_simulator(name="carla")
class CUDASimulator(Simulator):
  """The single-scene simulator, registered as ``"carla"``: the reference's
  ``CARLASimulator`` API over one scene of the port's world on
  ``device``."""

  def __init__(
      self,
      town: str,
      fps: int = defaults.SIMULATOR_FPS,
      sensors: Sequence[str] = defaults.CARLA_SENSORS,
      spawn_point: Optional[int] = None,
      destination: Optional[int] = None,
      num_vehicles: int = 0,
      num_pedestrians: int = 0,
      route_capacity: int = defaults.DEFAULT_ROUTE_CAPACITY,
      warmup_steps: int = defaults.WARMUP_STEPS,
      device="cuda",
  ) -> None:
    """Args:
      device: where the scene lives; ``"cuda"`` unless the caller asks for
        ``"cpu"``.  Raises when it names CUDA and no card is present.
    """
    assert town in defaults.AVAILABLE_CARLA_TOWNS
    self._device = device_lib.resolve(device)
    self._town_name = town
    self._town = load_town(town)
    self._fps = fps
    self._params = make_params(self._town, fps=fps, device=self._device)
    self._spawn_point = spawn_point
    self._destination_idx = destination
    self._num_vehicles = int(num_vehicles)
    self._num_pedestrians = int(num_pedestrians)
    self._route_capacity = int(route_capacity)
    self._warmup_steps = int(warmup_steps)
    self._seed = np.random.randint(2**31 - 1)
    self._episode = 0

    # Sensor shells.
    sensor_classes = []
    device_keys = []
    for name in sensors:
      cls = registry.get_sensor(name)
      if cls is None:
        raise ValueError("Unregistered sensor {!r}".format(name))
      sensor_classes.append(cls.default())
      if name in _DEVICE_KEYS:
        device_keys.append(name)
    self._sensor_suite = SensorSuite(sensor_classes)
    self._device_keys = tuple(sorted(device_keys))
    # The static buffers of the captured steps, made at the first reset:
    # the scene, the step's action and the warm-up's zero action.
    self._state = None
    self._action = torch.zeros((1, 3), dtype=torch.float32,
                               device=self._device)
    self._zero = torch.zeros((1, 3), dtype=torch.float32,
                             device=self._device)
    self._pool = graphs.new_pool(self._device)
    self._step_fn = None
    self._warmup_fn = None
    # id(owner) -> (owner, its step): ``captured_step``'s steps.
    self._owned_steps = {}
    self._last_action = None

  # -- Simulator interface -------------------------------------------------

  @property
  def sensor_suite(self) -> SensorSuite:
    return self._sensor_suite

  @property
  def device(self) -> torch.device:
    return self._device

  @property
  def town(self):
    return self._town

  @property
  def params(self):
    return self._params

  @property
  def state(self):
    """A copy of the scene as a ``SceneState`` batch of one on
    ``device`` (the next step overwrites the live one)."""
    return None if self._state is None else clone_state(self._state)

  @state.setter
  def state(self, value) -> None:
    """Agents that own controller state inside the scene (the autopilot's
    PIDs and key) write it back here: copied into the live buffers."""
    copy_state_(self._state, value)

  @property
  def destination(self):
    """Destination location as an object with `.location` (x, y, z),
    matching the `carla.Transform`-shaped attribute agents poke at."""
    if self._state is None:
      return None
    xy = self._state.destination_xy[0].cpu().numpy()

    class _Loc:
      x, y, z = float(xy[0]), float(xy[1]), 0.0

      def __iter__(self):
        return iter((self.x, self.y, self.z))

    class _Transform:
      location = _Loc()

    return _Transform()

  def action_space(self) -> spaces.Dict:
    return spaces.Dict(
        throttle=spaces.Box(low=0.0, high=1.0, shape=(), dtype=np.float32),
        steer=spaces.Box(low=-1.0, high=1.0, shape=(), dtype=np.float32),
        brake=spaces.Box(low=0.0, high=1.0, shape=(), dtype=np.float32),
    )

  def seed(self, seed: int) -> None:
    self._seed = int(seed)

  def captured_step(self, owner, fn):
    """Runs ``fn(state)`` on the scene's live buffers as ``owner``'s
    captured step (built at its first call, in the simulator's graph
    pool) and returns what it returns: the graph's own tensors on a card
    (copy what you keep).  For an agent that reads the scene and writes
    its controller state back every step, as the JAX agents jit their
    policies; ``fn`` writes what it changes into ``state`` in place
    (``sim.types.copy_state_``).  Call it after ``reset``."""
    entry = self._owned_steps.get(id(owner))
    if entry is None:
      state = self._state
      entry = (owner, graphs.CapturedStep(lambda: fn(state), self._device,
                                          pool=self._pool))
      self._owned_steps[id(owner)] = entry
    return entry[1]()

  def _compile(self) -> None:
    """The captured step and warm-up step over the static buffers."""
    params, state, keys = self._params, self._state, self._device_keys

    def fused():
      new_state = world_step(params, state, self._action)
      obs = synth.synthesize(params, new_state, keys)
      copy_state_(state, new_state)
      return obs

    def warmup():
      copy_state_(state, world_step(params, state, self._zero))

    self._step_fn = graphs.CapturedStep(fused, self._device, pool=self._pool)
    self._warmup_fn = graphs.CapturedStep(warmup, self._device,
                                          pool=self._pool)

  def reset(self, *args: Any, **kwargs: Any) -> Observations:
    self._episode += 1
    scene = init_scene(
        self._town,
        spawn_point=self._spawn_point,
        destination=self._destination_idx,
        num_vehicles=self._num_vehicles,
        num_pedestrians=self._num_pedestrians,
        route_capacity=self._route_capacity,
        jax_seed=self._seed + self._episode,
        device=self._device,
    )
    if self._state is None:
      self._state = scene
      self._compile()
    else:
      # Into the buffers the captured steps read: rebinding would leave
      # them reading the last episode's.
      copy_state_(self._state, scene)
    for _ in range(self._warmup_steps):
      self._warmup_fn()
    # The first observation comes from the current state: no step.
    return self._materialise(
        synth.synthesize(self._params, self._state, self._device_keys))

  def step(self, action: Any, *args: Any, **kwargs: Any) -> Observations:
    action = _to_action_array(action)
    self._action.copy_(torch.as_tensor(action[None]))
    self._last_action = action
    # The graph's own tensors: _materialise copies them to the host.
    return self._materialise(self._step_fn())

  def _materialise(self, obs: Mapping[str, torch.Tensor]) -> Observations:
    """The sensors' values: host copies (an observation may be a live
    buffer, or the graph's own tensor, which the next step overwrites)."""
    for key, value in obs.items():
      sensor = self._sensor_suite.get(key)
      if isinstance(sensor, DeviceSensor):
        sensor.set_value(value[0].to("cpu", copy=True).numpy())
    return self._sensor_suite.get_observations()

  def render(self, mode: str = "rgb_array", *args: Any,
             **kwargs: Any) -> np.ndarray:
    """Renders the scene on the host as a uint8 frame.

    ``rgb_array``: the bird's-eye RGB frame.
    ``human``: the dashboard: the bird view, the front camera and the
    LIDAR splat side by side over a state HUD (speed, step, collision flag,
    control bars), the role of the reference's pygame dashboard.
    """
    if self._state is None:
      return np.zeros((defaults.BIRD_VIEW_IMAGE_SIZE,
                       defaults.BIRD_VIEW_IMAGE_SIZE, 3), dtype=np.uint8)
    if mode == "human":
      return self._render_dashboard()
    frame = synth.bird_view_rgb(self._params, self._state)[0].cpu().numpy()
    return (np.clip(frame, 0.0, 1.0) * 255).astype(np.uint8)

  def _render_dashboard(self) -> np.ndarray:
    """The ``human`` frame: the panels synthesised on ``device`` (the
    LIDAR through ``synth.lidar``, so the splat kernel on a card), then
    composed with ``utils.graphics``."""
    from oatomobile_torch.sensors import cameras  # pylint: disable=import-outside-toplevel
    from oatomobile_torch.utils import graphics  # pylint: disable=import-outside-toplevel
    params, state = self._params, self._state
    # Left to right in the JAX package's frame, whose jitted dict of
    # panels comes back with its keys sorted.
    panels = {
        "bird_view": synth.bird_view_rgb(params, state),
        "front_camera_rgb": cameras.camera_rgb(params, state, 0.0),
        "lidar": synth.lidar(params, state),
    }
    panels = {k: v[0].cpu().numpy() for k, v in panels.items()}
    last = self._last_action
    hud = {
        "speed_mps": float(state.hero_speed[0]),
        "step": int(state.step[0]),
        "collided": float(state.collision[0]) > 0,
        "throttle": float(last[0]) if last is not None else 0.0,
        "steer": float(last[1]) if last is not None else 0.0,
        "brake": float(last[2]) if last is not None else 0.0,
    }
    return graphics.compose_dashboard_frame(panels, hud)

  def close(self) -> None:
    self._state = None
    self._step_fn = self._warmup_fn = None
    self._owned_steps = {}
