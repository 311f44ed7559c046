"""Small tensor helpers shared by the simulator modules.

Each reproduces the float32 rounding of the JAX expression it replaces,
so one step of the port matches one step of the JAX package to the ulp
wherever the two libraries' elementary functions agree.
"""

import functools

import torch


@functools.lru_cache(maxsize=None)
def constant(values, device) -> torch.Tensor:
  """float32 tensor of the nested tuple ``values`` on ``device``, made once
  per device: building it from host data inside the step would cost a
  blocking host-to-device copy every call."""
  return torch.tensor(values, dtype=torch.float32, device=device)


def norm(x: torch.Tensor) -> torch.Tensor:
  """``jnp.linalg.norm(x, axis=-1)``: sqrt of the sum of squares (not
  torch.linalg.norm, which may scale to avoid overflow)."""
  return torch.sqrt((x * x).sum(-1))


def hypot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
  """``jnp.hypot``: max * sqrt(1 + (min / max)^2), 0 where both are 0."""
  x, y = x.abs(), y.abs()
  hi, lo = torch.maximum(x, y), torch.minimum(x, y)
  zero = hi == 0
  out = hi * torch.sqrt(1 + torch.square(lo / torch.where(zero, 1.0, hi)))
  return torch.where(zero, hi, out)


def wrap_angle(a: torch.Tensor) -> torch.Tensor:
  """``arctan2(sin a, cos a)``: ``a`` wrapped into (-pi, pi]."""
  return torch.atan2(torch.sin(a), torch.cos(a))


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
  """Per-scene gather: ``out[b, ...] = x[b, idx[b, ...]]``.

  ``x`` is ``[B, N, *rest]`` and ``idx`` is ``[B, *shape]`` with entries in
  ``[0, N)``; returns ``[B, *shape, *rest]`` (the vmapped ``x[idx]``)."""
  B, rest = x.shape[0], x.shape[2:]
  flat = idx.reshape(B, -1).long()
  if rest:
    flat_x = x.reshape(B, x.shape[1], -1)
    out = torch.gather(flat_x, 1,
                       flat[..., None].expand(-1, -1, flat_x.shape[-1]))
  else:
    out = torch.gather(x, 1, flat)
  return out.reshape(idx.shape + rest)
