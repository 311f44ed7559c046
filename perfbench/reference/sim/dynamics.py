"""Vehicle dynamics and controllers, elementwise over any batch shape.

Port of the JAX package's ``sim/dynamics.py``: a kinematic bicycle model
and CARLA's ``VehiclePIDController`` with the reference gains and a
30-sample sliding-window integral.
"""

from typing import Tuple

import torch

from perfbench.reference.sim.types import PIDState, VehicleSpec

# Reference PID gains (baselines/base.py:32-43 of the reference).
LATERAL_PID = {"K_P": 1.95, "K_D": 0.01, "K_I": 1.4}
LONGITUDINAL_PID = {"K_P": 1.0, "K_D": 0.0, "K_I": 1.0}


def bicycle_step(
    xy: torch.Tensor,
    yaw: torch.Tensor,
    speed: torch.Tensor,
    throttle: torch.Tensor,
    steer: torch.Tensor,
    brake: torch.Tensor,
    spec: VehicleSpec,
    dt: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """One kinematic-bicycle integration step (heroes: [B], NPCs: [B, K]).

  Returns:
    (new_xy, new_yaw, new_speed).
  """
  throttle = torch.clamp(throttle, 0.0, 1.0)
  steer = torch.clamp(steer, -1.0, 1.0)
  brake = torch.clamp(brake, 0.0, 1.0)

  accel = (throttle * spec.max_accel - brake * spec.max_brake -
           spec.drag * speed * speed -
           torch.where(speed > 0.0, spec.roll, 0.0))
  new_speed = torch.clamp_min(speed + dt * accel, 0.0)

  wheel = steer * spec.max_steer_rad
  yaw_rate = new_speed / spec.wheelbase * torch.tan(wheel)
  new_yaw = yaw + dt * yaw_rate
  # Midpoint heading keeps circular arcs honest at 20 Hz.
  mid = 0.5 * (yaw + new_yaw)
  heading = torch.stack([torch.cos(mid), torch.sin(mid)], dim=-1)
  new_xy = xy + (dt * new_speed)[..., None] * heading
  return new_xy, new_yaw, new_speed


def pid_update(state: PIDState, error: torch.Tensor, dt: torch.Tensor,
               k_p: float, k_d: float, k_i: float) -> Tuple[torch.Tensor,
                                                            PIDState]:
  """Single PID update with CARLA's sliding-window integral (a shift
  register along the last axis of ``err_buf``)."""
  derivative = (error - state.prev_error) / dt
  err_buf = torch.cat([state.err_buf[..., 1:], error[..., None]], dim=-1)
  integral = torch.sum(err_buf, dim=-1) * dt
  out = k_p * error + k_d * derivative + k_i * integral
  return out, PIDState(err_buf=err_buf, prev_error=error)


def longitudinal_control(state: PIDState, current_speed: torch.Tensor,
                         target_speed: torch.Tensor,
                         dt: torch.Tensor) -> Tuple[torch.Tensor, PIDState]:
  """Throttle from the speed error in km/h, clipped to [0, 1]: CARLA's
  PIDLongitudinalController, which cannot brake."""
  error = (target_speed - current_speed) * 3.6
  out, new_state = pid_update(state, error, dt,
                              k_p=LONGITUDINAL_PID["K_P"],
                              k_d=LONGITUDINAL_PID["K_D"],
                              k_i=LONGITUDINAL_PID["K_I"])
  return torch.clamp(out, 0.0, 1.0), new_state


def longitudinal_control_with_brake(
    state: PIDState, current_speed: torch.Tensor, target_speed: torch.Tensor,
    dt: torch.Tensor, *, brake_deadband: float = 0.1,
    brake_slope: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor, PIDState]:
  """(throttle, brake, state) from the speed error in km/h; a negative PID
  output maps to the brake pedal past a dead-band (see the JAX package's
  docstring for why the autopilot may brake where CARLA's controller
  cannot)."""
  error = (target_speed - current_speed) * 3.6
  out, new_state = pid_update(state, error, dt,
                              k_p=LONGITUDINAL_PID["K_P"],
                              k_d=LONGITUDINAL_PID["K_D"],
                              k_i=LONGITUDINAL_PID["K_I"])
  throttle = torch.clamp(out, 0.0, 1.0)
  brake = torch.clamp(brake_slope * (-out - brake_deadband), 0.0, 1.0)
  return throttle, brake, new_state


def lateral_control(state: PIDState, xy: torch.Tensor, yaw: torch.Tensor,
                    target_xy: torch.Tensor,
                    dt: torch.Tensor) -> Tuple[torch.Tensor, PIDState]:
  """Steering from the signed angle between the heading and the ray to the
  target waypoint (CARLA PIDLateralController semantics)."""
  forward = torch.stack([torch.cos(yaw), torch.sin(yaw)], dim=-1)
  to_target = target_xy - xy
  norm = torch.sqrt((to_target * to_target).sum(-1)) + 1e-6
  cos_a = torch.clamp(torch.sum(forward * to_target, dim=-1) / norm, -1.0,
                      1.0)
  angle = torch.arccos(cos_a)
  # Sign from the 2D cross product (positive -> target to the right).
  cross = forward[..., 0] * to_target[..., 1] - forward[..., 1] * to_target[
      ..., 0]
  error = torch.where(cross < 0.0, -angle, angle)
  out, new_state = pid_update(state, error, dt,
                              k_p=LATERAL_PID["K_P"],
                              k_d=LATERAL_PID["K_D"],
                              k_i=LATERAL_PID["K_I"])
  return torch.clamp(out, -1.0, 1.0), new_state
