"""Coordinate transforms between world and ego (local) frames: the port of
the JAX package's ``ops/transforms.py``.

``world2local``, ``local2world``, ``rot2mat``, the planar
``world2local_2d`` / ``local2world_2d``, ``yaw_to_forward`` and
``wrap_angle`` take numpy arrays or torch tensors: given a tensor they
compute in torch on its device (the counterpart of the JAX functions with
``xp=jnp``), otherwise in numpy (with ``xp=np``).  ``np_world2local`` and
``np_local2world`` are the host-side float64 twins.

Rotations are CARLA ``(pitch, yaw, roll)`` triplets in *degrees*;
``rot2mat(rotation) = euler2mat(roll, pitch, yaw).T`` in the static-xyz
convention, i.e. ``(Rz(yaw) @ Ry(pitch) @ Rx(roll)).T``, and

    world2local(x) = R @ (x - loc)
    local2world(x) = R^{-1} @ x + loc
"""

import numpy as np
import torch


def _is_torch(*values) -> bool:
  return any(isinstance(v, torch.Tensor) for v in values)


def _stack(xs, axis: int):
  if _is_torch(*xs):
    return torch.stack(xs, dim=axis)
  return np.stack(xs, axis=axis)


def _euler_zyx(roll, pitch, yaw):
  """Rz(yaw) @ Ry(pitch) @ Rx(roll) (static xyz convention), stacked."""
  xp = torch if _is_torch(roll) else np
  cr, sr = xp.cos(roll), xp.sin(roll)
  cp, sp = xp.cos(pitch), xp.sin(pitch)
  cy, sy = xp.cos(yaw), xp.sin(yaw)
  row0 = _stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
                -1)
  row1 = _stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
                -1)
  row2 = _stack([-sp, cp * sr, cp * cr], -1)
  return _stack([row0, row1, row2], -2)


def rot2mat(rotation):
  """``[..., 3, 3]`` world->local rotation matrices of ``[..., 3]`` CARLA
  rotations (pitch, yaw, roll) in degrees: ``euler2mat(roll, pitch,
  yaw).T``."""
  if _is_torch(rotation):
    pitch, yaw, roll = torch.deg2rad(rotation).unbind(-1)
    return _euler_zyx(roll, pitch, yaw).transpose(-1, -2)
  rotation = np.asarray(rotation)
  pitch = np.deg2rad(rotation[..., 0])
  yaw = np.deg2rad(rotation[..., 1])
  roll = np.deg2rad(rotation[..., 2])
  return np.swapaxes(_euler_zyx(roll, pitch, yaw), -1, -2)


def _einsum(equation: str, *operands):
  if _is_torch(*operands):
    return torch.einsum(equation, *operands)
  return np.einsum(equation, *operands)


def world2local(*, current_location, current_rotation, world_locations):
  """``world_locations`` (``[..., N, 3]`` or ``[..., 3]``) in the ego frame
  of ``current_location`` ``[..., 3]`` and ``current_rotation``
  ``[..., 3]`` (degrees); same shape as ``world_locations``."""
  if not _is_torch(current_location, current_rotation, world_locations):
    current_location = np.asarray(current_location)
    world_locations = np.asarray(world_locations)
  R = rot2mat(current_rotation)
  delta = world_locations - current_location[..., None, :] \
      if world_locations.ndim > current_location.ndim else \
      world_locations - current_location
  return _einsum("...ij,...j->...i", R, delta) \
      if delta.ndim == R.ndim - 1 else \
      _einsum("...ij,...nj->...ni", R, delta)


def local2world(*, current_location, current_rotation, local_locations):
  """Converts ``local_locations`` to world coordinates (inverse of
  :func:`world2local`)."""
  if not _is_torch(current_location, current_rotation, local_locations):
    current_location = np.asarray(current_location)
    local_locations = np.asarray(local_locations)
  R = rot2mat(current_rotation)
  # R is orthonormal: its inverse is its transpose.
  Rt = R.transpose(-1, -2) if _is_torch(R) else np.swapaxes(R, -1, -2)
  if local_locations.ndim == R.ndim - 1:
    return _einsum("...ij,...j->...i", Rt, local_locations) + \
        current_location
  out = _einsum("...ij,...nj->...ni", Rt, local_locations)
  return out + current_location[..., None, :]


def yaw_to_forward(yaw_deg):
  """Unit forward vector ``[..., 3]`` of a (pitch 0) yaw in degrees, CARLA
  convention: ``get_forward_vector() == (cos(yaw), sin(yaw), 0)``."""
  xp = torch if _is_torch(yaw_deg) else np
  yaw = xp.deg2rad(yaw_deg if _is_torch(yaw_deg) else np.asarray(yaw_deg))
  return _stack([xp.cos(yaw), xp.sin(yaw), xp.zeros_like(yaw)], -1)


def world2local_2d(*, current_xy, current_yaw_rad, world_xy):
  """Planar world -> ego frame (a yaw-only rotation): ``world_xy``
  ``[..., N, 2]`` in the frame of ``current_xy`` ``[..., 2]`` and
  ``current_yaw_rad`` ``[...]``; x forward, y right."""
  xp = torch if _is_torch(current_xy, current_yaw_rad, world_xy) else np
  c = xp.cos(current_yaw_rad)
  s = xp.sin(current_yaw_rad)
  delta = world_xy - current_xy[..., None, :]
  x = c[..., None] * delta[..., 0] + s[..., None] * delta[..., 1]
  y = -s[..., None] * delta[..., 0] + c[..., None] * delta[..., 1]
  return _stack([x, y], -1)


def local2world_2d(*, current_xy, current_yaw_rad, local_xy):
  """Inverse of :func:`world2local_2d`."""
  xp = torch if _is_torch(current_xy, current_yaw_rad, local_xy) else np
  c = xp.cos(current_yaw_rad)
  s = xp.sin(current_yaw_rad)
  x = c[..., None] * local_xy[..., 0] - s[..., None] * local_xy[..., 1]
  y = s[..., None] * local_xy[..., 0] + c[..., None] * local_xy[..., 1]
  return _stack([x, y], -1) + current_xy[..., None, :]


def wrap_angle(theta):
  """Radians wrapped to (-pi, pi]: ``arctan2(sin theta, cos theta)``."""
  if _is_torch(theta):
    return torch.atan2(torch.sin(theta), torch.cos(theta))
  return np.arctan2(np.sin(theta), np.cos(theta))


def np_world2local(*, current_location, current_rotation, world_locations):
  """:func:`world2local` in float64 on at-least-2-D points, squeezed."""
  out = world2local(
      current_location=np.asarray(current_location, dtype=np.float64),
      current_rotation=np.asarray(current_rotation, dtype=np.float64),
      world_locations=np.atleast_2d(np.asarray(world_locations,
                                               dtype=np.float64)))
  return np.squeeze(out)


def np_local2world(*, current_location, current_rotation, local_locations):
  """:func:`local2world` in float64 on at-least-2-D points."""
  return local2world(
      current_location=np.asarray(current_location, dtype=np.float64),
      current_rotation=np.asarray(current_rotation, dtype=np.float64),
      local_locations=np.atleast_2d(np.asarray(local_locations,
                                               dtype=np.float64)))
