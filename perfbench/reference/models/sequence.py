"""Autoregressive flow over trajectories: port of the JAX package's
``models/sequence.py``.

A GRU-driven invertible affine autoregressive flow, unrolled over the
T = 4 decode steps:

    _forward: x (base) -> y (data),   y_t = (y_{t-1} + dloc_t) + scale_t*x_t
    _inverse: y (data) -> x (base),   x_t = (y_t - (y_{t-1} + dloc_t))/scale_t
    scale_t  = softplus(head(z_t)[2:]) + 1e-3
    logabsdet = sum_t sum_d log scale_td     (both directions)

flax's ``GRUCell(carry, inputs)`` is ``GRUCell(inputs, carry)`` here: the
same gates and exactly flax's parameters.  ``torch.nn.GRUCell`` would hold
trainable hidden biases for the r and z gates, which flax's ``hr`` and
``hz`` denses do not have: an optimiser step would move them.
"""

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from perfbench.reference.models import initializers
from perfbench.reference.models.mlp import MLP

# log(2 pi) as the JAX package rounds it: a float32 log of a float32.
LOG_2PI = float(np.log(np.float32(2.0 * np.pi)))


class GRUCell(nn.Module):
  """flax's ``GRUCell`` with torch's gate layout: input kernels ``weight_ih``
  ``[3H, D]`` (r, z, n) with biases ``bias_ih`` ``[3H]``, recurrent kernels
  ``weight_hh`` ``[3H, H]``, and one recurrent bias ``bias_hn`` ``[H]``, of
  the n gate only.  Computed by ``torch.gru_cell`` (fused on the card)
  with the r and z hidden biases fixed at 0."""

  def __init__(self, input_size: int, hidden_size: int, device=None) -> None:
    super().__init__()
    self.input_size, self.hidden_size = input_size, hidden_size
    h = hidden_size
    self.weight_ih = nn.Parameter(torch.empty(3 * h, input_size,
                                              device=device))
    self.bias_ih = nn.Parameter(torch.empty(3 * h, device=device))
    self.weight_hh = nn.Parameter(torch.empty(3 * h, h, device=device))
    self.bias_hn = nn.Parameter(torch.empty(h, device=device))

  @property
  def bias_hh(self) -> torch.Tensor:
    """``[3H]`` hidden biases as ``torch.nn.GRUCell`` lays them out: 0 for
    r and z, ``bias_hn`` for n."""
    return F.pad(self.bias_hn, (2 * self.hidden_size, 0))

  def forward(self, inputs: torch.Tensor, carry: torch.Tensor) -> torch.Tensor:
    return torch.gru_cell(inputs, carry, self.weight_ih, self.weight_hh,
                          self.bias_ih, self.bias_hh)


class AutoregressiveFlow(nn.Module):
  """An autoregressive flow-based sequence generator."""

  def __init__(self,
               output_shape: Tuple[int, int] = (4, 2),
               hidden_size: int = 64,
               *,
               generator: Optional[torch.Generator] = None,
               device="cuda") -> None:
    super().__init__()
    device = torch.device(device)
    self.output_shape = tuple(output_shape)
    d = self.output_shape[-1]
    self.gru = GRUCell(d, hidden_size, device="meta")
    # Head: (dloc [D], raw_scale [D]).
    self.locscale = MLP(hidden_size, (32, 2 * d), device="meta")
    initializers.materialize(self, generator, device)

  def _step_params(self, z: torch.Tensor, y_tm1: torch.Tensor):
    """One GRU unroll: returns (new_z, dloc, scale)."""
    new_z = self.gru(y_tm1, z)
    dloc_scale = self.locscale(new_z)
    d = self.output_shape[-1]
    scale = F.softplus(dloc_scale[..., d:]) + 1e-3
    return new_z, dloc_scale[..., :d], scale

  def forward(self, z: torch.Tensor,
              generator: torch.Generator) -> torch.Tensor:
    """Stochastic generation: base noise from ``generator`` (on its own
    device) pushed forward."""
    x = torch.randn(z.shape[:-1] + self.output_shape, generator=generator,
                    device=generator.device).to(z.device)
    return self._forward(x, z)[0]

  def _forward(self, x: torch.Tensor,
               z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Base samples x [..., T, D] and context z [..., H] to
    (y [..., T, D], logabsdet [...])."""
    T, d = self.output_shape
    y_tm1 = torch.zeros(z.shape[:-1] + (d,), dtype=z.dtype, device=z.device)
    zt = z
    ys, log_scales = [], []
    for t in range(T):
      zt, dloc, scale = self._step_params(zt, y_tm1)
      y_t = (y_tm1 + dloc) + scale * x[..., t, :]
      ys.append(y_t)
      log_scales.append(torch.log(scale))
      y_tm1 = y_t
    logabsdet = torch.stack(log_scales, dim=-2).sum(dim=(-2, -1))
    return torch.stack(ys, dim=-2), logabsdet

  def _inverse(self, y: torch.Tensor, z: torch.Tensor):
    """Data samples y [..., T, D] to (x [..., T, D], log_prob [...],
    logabsdet [...]), log_prob being the standard-normal density of x."""
    T, d = self.output_shape
    y_tm1 = torch.zeros(z.shape[:-1] + (d,), dtype=z.dtype, device=z.device)
    zt = z
    xs, log_scales = [], []
    for t in range(T):
      zt, dloc, scale = self._step_params(zt, y_tm1)
      y_t = y[..., t, :]
      xs.append((y_t - (y_tm1 + dloc)) / scale)
      log_scales.append(torch.log(scale))
      y_tm1 = y_t
    x = torch.stack(xs, dim=-2)
    logabsdet = torch.stack(log_scales, dim=-2).sum(dim=(-2, -1))
    log_prob = -0.5 * (x * x).sum(dim=(-2, -1)) - 0.5 * T * d * LOG_2PI
    return x, log_prob, logabsdet
