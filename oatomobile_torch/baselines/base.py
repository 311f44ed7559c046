"""Setpoint-based agent interface, model plan -> PID control: a copy of
the JAX package's ``baselines/base.py`` (host-side numpy).

Subclasses implement ``__call__(obs) -> plan [T, 3]`` in ego coordinates;
``act`` replans every ``replan_every_steps``, converts the plan to the
world frame, derives a target speed from the setpoints' spacing, and
tracks the setpoint with lateral/longitudinal PID controllers with the
reference's gains.
"""

import abc
import collections
from typing import Any, Mapping, Optional

import numpy as np

import oatomobile_torch
from oatomobile_torch.ops import transforms as tf_ops
from oatomobile_torch.simulators.cuda.simulator import CARLAAction

# Default PID controllers configuration (reference base.py:31-43).
SIMULATOR_FPS = 20
LATERAL_PID_CONTROLLER_CONFIG = {
    "K_P": 1.95,
    "K_D": 0.01,
    "K_I": 1.4,
    "dt": 1.0 / SIMULATOR_FPS,
}
LONGITUDINAL_PID_CONTROLLER_CONFIG = {
    "K_P": 1.0,
    "K_D": 0,
    "K_I": 1.0,
    "dt": 1.0 / SIMULATOR_FPS,
}

_PID_WINDOW = 30  # CARLA's error deque length (see sim/dynamics.pid_update).


class _HostPID:
  """Scalar PID with sliding-window integral (host-side twin of
  sim/dynamics.pid_update, matching CARLA's deque(maxlen=30))."""

  def __init__(self, k_p: float, k_d: float, k_i: float, dt: float) -> None:
    self.k_p, self.k_d, self.k_i, self.dt = k_p, k_d, k_i, dt
    self.err_buf = collections.deque(maxlen=_PID_WINDOW)
    self.prev_error = 0.0

  def step(self, error: float) -> float:
    derivative = (error - self.prev_error) / self.dt
    self.err_buf.append(error)
    integral = sum(self.err_buf) * self.dt
    self.prev_error = error
    return (self.k_p * error + self.k_d * derivative +
            self.k_i * integral)


class SetPointAgent(oatomobile_torch.Agent):
  """An agent that predicts setpoints and consumes them with PID."""

  def __init__(
      self,
      environment: oatomobile_torch.Env,
      *,
      setpoint_index: int = 5,
      replan_every_steps: int = 1,
      lateral_control_dict: Mapping[str, Any] = LATERAL_PID_CONTROLLER_CONFIG,
      longitudinal_control_dict: Mapping[
          str, Any] = LONGITUDINAL_PID_CONTROLLER_CONFIG,
      fixed_delta_seconds_between_setpoints: Optional[float] = None) -> None:
    super().__init__(environment=environment)

    sim = self._environment.unwrapped.simulator
    dt = 1.0 / getattr(sim, "_fps", SIMULATOR_FPS)
    self._dt = dt
    self._pid_lat = _HostPID(lateral_control_dict["K_P"],
                             lateral_control_dict["K_D"],
                             lateral_control_dict["K_I"], dt)
    self._pid_lon = _HostPID(longitudinal_control_dict["K_P"],
                             longitudinal_control_dict["K_D"],
                             longitudinal_control_dict["K_I"], dt)

    self._setpoint_index = setpoint_index
    self._replan_every_steps = replan_every_steps
    self._fixed_delta_seconds_between_setpoints = (
        fixed_delta_seconds_between_setpoints or dt)

    self._setpoints_buffer = None
    self._steps_counter = 0

  @abc.abstractmethod
  def __call__(self, observation: oatomobile_torch.Observations, *args,
               **kwargs) -> np.ndarray:
    """Returns the predicted plan in ego-coordinates [T, 3]."""

  def act(self, observation: oatomobile_torch.Observations, *args,
          **kwargs) -> oatomobile_torch.Action:
    """Reference flow (base.py:116-176): replan -> world frame -> buffer ->
    predictions write-back -> target speed -> PID."""
    current_location = np.asarray(observation["location"], dtype=np.float64)
    current_rotation = np.asarray(observation["rotation"], dtype=np.float64)

    if (self._setpoints_buffer is None or
        self._steps_counter % self._replan_every_steps == 0):
      predicted_plan_ego = np.asarray(
          self(dict(observation), *args, **kwargs))  # [T, 3]
      predicted_plan_world = tf_ops.np_local2world(
          current_location=current_location,
          current_rotation=current_rotation,
          local_locations=predicted_plan_ego,
      )
      self._setpoints_buffer = np.atleast_2d(predicted_plan_world)
    else:
      self._setpoints_buffer = self._setpoints_buffer[1:]

    # Registers setpoints for rendering (reference base.py:145-150).
    predictions_sensor = self._environment.unwrapped.simulator.sensor_suite.get(
        "predictions")
    if predictions_sensor is not None:
      predictions_sensor.predictions = tf_ops.np_world2local(
          current_location=current_location,
          current_rotation=current_rotation,
          world_locations=self._setpoints_buffer,
      )

    self._steps_counter += 1

    # Target speed from the mean spacing of the first setpoints.
    window = self._setpoints_buffer[:self._setpoint_index]
    if len(window) >= 2:
      target_speed = float(
          np.linalg.norm(np.diff(window, axis=0), axis=1).mean() /
          self._fixed_delta_seconds_between_setpoints)
    else:
      target_speed = 0.0

    setpoint = self._setpoints_buffer[min(
        self._setpoint_index, len(self._setpoints_buffer) - 1)]

    # Avoids getting stuck when spawned (base.py:165-167).
    if self._steps_counter <= 100:
      target_speed = 20.0 / 3.6

    # PID step.  Longitudinal operates in km/h like CARLA's controller.
    speed = float(np.linalg.norm(observation.get("velocity", np.zeros(3))))
    throttle = float(
        np.clip(self._pid_lon.step((target_speed - speed) * 3.6), 0.0, 1.0))

    yaw = np.deg2rad(current_rotation[1])
    forward = np.array([np.cos(yaw), np.sin(yaw)])
    to_target = setpoint[:2] - current_location[:2]
    norm = np.linalg.norm(to_target) + 1e-6
    cos_a = np.clip(forward @ to_target / norm, -1.0, 1.0)
    angle = float(np.arccos(cos_a))
    cross = forward[0] * to_target[1] - forward[1] * to_target[0]
    error = -angle if cross < 0.0 else angle
    steer = float(np.clip(self._pid_lat.step(error), -1.0, 1.0))

    return CARLAAction(throttle=throttle, steer=steer, brake=0.0)
