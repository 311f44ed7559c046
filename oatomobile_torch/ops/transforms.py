"""Coordinate transforms between world and ego (local) frames, host-side
numpy: the numpy half of the JAX package's ``ops/transforms.py``
(``np_world2local``, ``np_local2world`` and what they call).

Rotations are CARLA ``(pitch, yaw, roll)`` triplets in *degrees*;
``rot2mat(rotation) = euler2mat(roll, pitch, yaw).T`` in the static-xyz
convention, i.e. ``(Rz(yaw) @ Ry(pitch) @ Rx(roll)).T``, and

    world2local(x) = R @ (x - loc)
    local2world(x) = R^{-1} @ x + loc
"""

import numpy as np


def _euler_zyx(roll, pitch, yaw):
  """Rz(yaw) @ Ry(pitch) @ Rx(roll) (static xyz convention), stacked."""
  cr, sr = np.cos(roll), np.sin(roll)
  cp, sp = np.cos(pitch), np.sin(pitch)
  cy, sy = np.cos(yaw), np.sin(yaw)
  row0 = np.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
                  axis=-1)
  row1 = np.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
                  axis=-1)
  row2 = np.stack([-sp, cp * sr, cp * cr], axis=-1)
  return np.stack([row0, row1, row2], axis=-2)


def rot2mat(rotation) -> np.ndarray:
  """``[..., 3, 3]`` world->local rotation matrices of ``[..., 3]`` CARLA
  rotations (pitch, yaw, roll) in degrees: ``euler2mat(roll, pitch,
  yaw).T``."""
  rotation = np.asarray(rotation)
  pitch = np.deg2rad(rotation[..., 0])
  yaw = np.deg2rad(rotation[..., 1])
  roll = np.deg2rad(rotation[..., 2])
  return np.swapaxes(_euler_zyx(roll, pitch, yaw), -1, -2)


def world2local(*, current_location, current_rotation,
                world_locations) -> np.ndarray:
  """``world_locations`` (``[..., N, 3]`` or ``[..., 3]``) in the ego frame
  of ``current_location`` ``[..., 3]`` and ``current_rotation``
  ``[..., 3]`` (degrees); same shape as ``world_locations``."""
  current_location = np.asarray(current_location)
  world_locations = np.asarray(world_locations)
  R = rot2mat(current_rotation)
  delta = world_locations - current_location[..., None, :] \
      if world_locations.ndim > current_location.ndim else \
      world_locations - current_location
  return np.einsum("...ij,...j->...i", R, delta) \
      if delta.ndim == R.ndim - 1 else \
      np.einsum("...ij,...nj->...ni", R, delta)


def local2world(*, current_location, current_rotation,
                local_locations) -> np.ndarray:
  """Converts ``local_locations`` to world coordinates (inverse of
  :func:`world2local`)."""
  current_location = np.asarray(current_location)
  local_locations = np.asarray(local_locations)
  R = rot2mat(current_rotation)
  # R is orthonormal: its inverse is its transpose.
  Rt = np.swapaxes(R, -1, -2)
  if local_locations.ndim == R.ndim - 1:
    return np.einsum("...ij,...j->...i", Rt, local_locations) + \
        current_location
  out = np.einsum("...ij,...nj->...ni", Rt, local_locations)
  return out + current_location[..., None, :]


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
