"""Parameter initialisation with flax's distributions, from a
``torch.Generator``.

The JAX package's models draw their initial weights with flax's defaults:
``lecun_normal`` (truncated-normal variance scaling on fan-in) for Conv
and Dense kernels, zero biases, GroupNorm scale 1 and bias 0, and for the
GRU cell ``lecun_normal`` input kernels and orthogonal recurrent kernels.
The port's modules are built on the ``meta`` device and then materialised
here, so an untrained port model behaves statistically like
``model.init(PRNGKey(0))`` of the JAX package, though its values differ.
"""

import math
from typing import Optional

import torch
from torch import nn

# Standard deviation of a unit normal truncated to [-2, 2]: flax divides by
# it so that the truncated draw keeps the requested variance.
_TRUNCATED_STD = 0.87962566103423978


def _truncated_normal(shape, generator: torch.Generator) -> torch.Tensor:
  """Unit normal truncated to [-2, 2], by the inverse CDF (float64)."""
  lo, hi = (0.5 * (1.0 + math.erf(b / math.sqrt(2.0))) for b in (-2.0, 2.0))
  u = torch.rand(shape, generator=generator, dtype=torch.float64)
  p = lo + (hi - lo) * u
  return (math.sqrt(2.0) * torch.erfinv(2.0 * p - 1.0)).clamp_(-2.0, 2.0)


def lecun_normal(shape, fan_in: int,
                 generator: torch.Generator) -> torch.Tensor:
  """flax ``lecun_normal``: truncated normal with variance 1 / fan_in."""
  std = math.sqrt(1.0 / fan_in) / _TRUNCATED_STD
  return (_truncated_normal(shape, generator) * std).float()


def orthogonal(n: int, generator: torch.Generator) -> torch.Tensor:
  """flax ``orthogonal`` for a square ``[n, n]`` kernel: Q of the QR of a
  normal matrix, columns signed by R's diagonal."""
  a = torch.randn((n, n), generator=generator, dtype=torch.float64)
  q, r = torch.linalg.qr(a)
  return (q * torch.sign(torch.diagonal(r))).float()


@torch.no_grad()
def materialize(module: nn.Module, generator: Optional[torch.Generator],
                device: torch.device) -> None:
  """Gives every parameter of a module built on the ``meta`` device its
  flax initial value, drawn on the CPU from ``generator`` (a fresh one
  seeded 0 when None), and moves the module to ``device``.  A ``meta``
  ``device`` leaves the module unmaterialised: an enclosing module does it.
  """
  from perfbench.reference.models.sequence import GRUCell  # pylint: disable=import-outside-toplevel
  if device.type == "meta":
    return
  if generator is None:
    generator = torch.Generator().manual_seed(0)
  module.to_empty(device="cpu")
  for m in module.modules():
    if isinstance(m, nn.Conv2d):
      kh, kw = m.kernel_size
      fan_in = (m.in_channels // m.groups) * kh * kw
      m.weight.copy_(lecun_normal(m.weight.shape, fan_in, generator))
      if m.bias is not None:
        m.bias.zero_()
    elif isinstance(m, nn.Linear):
      m.weight.copy_(lecun_normal(m.weight.shape, m.in_features, generator))
      m.bias.zero_()
    elif isinstance(m, nn.GroupNorm):
      m.weight.fill_(1.0)
      m.bias.zero_()
    elif isinstance(m, GRUCell):
      # Gates (r, z, n) as flax draws them: one input kernel and one
      # recurrent kernel each.
      h = m.hidden_size
      for gate in range(3):
        rows = slice(gate * h, (gate + 1) * h)
        m.weight_ih[rows] = lecun_normal((h, m.input_size), m.input_size,
                                         generator)
        m.weight_hh[rows] = orthogonal(h, generator)
      m.bias_ih.zero_()
      m.bias_hn.zero_()
  module.to(device)
