"""Model weights drawn from a run's seed, on the device, in a few large
calls: the benchmark makes them and hands the same tensors to the program
and to the reference.

Scales follow flax's initial distributions by kind of parameter: a Conv or
Dense kernel and a GRU kernel are normal draws clipped to two standard
deviations with variance 1 / fan-in (flax draws the GRU's recurrent
kernels orthogonal: a departure of scale structure only), biases are 0,
GroupNorm scales 1.  The names and shapes come from the reference's own
module tree.
"""

import math
from typing import Dict

import torch
from torch import nn

# Standard deviation of a unit normal clipped to [-2, 2] (flax divides by
# it so that the truncated draw keeps its variance).
_CLIPPED_STD = 0.87962566103423978


def _fan_ins(model: nn.Module) -> Dict[str, int]:
  """name -> fan-in of every kernel; 0 for a zero bias; -1 for a unit
  GroupNorm scale.  Raises on a parameter of another kind."""
  out = {}
  for prefix, m in model.named_modules():
    name = (prefix + ".") if prefix else ""
    kind = type(m).__name__
    own = dict(m.named_parameters(recurse=False))
    if not own:
      continue
    if isinstance(m, nn.Conv2d):
      kh, kw = m.kernel_size
      out[name + "weight"] = (m.in_channels // m.groups) * kh * kw
      if m.bias is not None:
        out[name + "bias"] = 0
    elif isinstance(m, nn.Linear):
      out[name + "weight"] = m.in_features
      out[name + "bias"] = 0
    elif isinstance(m, nn.GroupNorm):
      out[name + "weight"] = -1
      out[name + "bias"] = 0
    elif kind == "GRUCell":
      out[name + "weight_ih"] = m.input_size
      out[name + "weight_hh"] = m.hidden_size
      out[name + "bias_ih"] = 0
      out[name + "bias_hn"] = 0
    else:
      raise ValueError("no initial distribution for {} ({})".format(
          prefix, kind))
    missing = {name + k for k in own} - set(out)
    if missing:
      raise ValueError("no initial distribution for {}".format(missing))
  return out


def draw(model: nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
  """name -> float32 tensor on ``device`` for every parameter of
  ``model`` (its module tree only is read: it may live on ``meta``)."""
  device = torch.device(device)
  fans = _fan_ins(model)
  shapes = {n: p.shape for n, p in model.named_parameters()}
  if set(shapes) != set(fans):
    raise ValueError("parameters without a distribution: {}".format(
        set(shapes) ^ set(fans)))
  kernels = [n for n in shapes if fans[n] > 0]
  sizes = [math.prod(shapes[n]) for n in kernels]
  gen = torch.Generator(device=device)
  gen.manual_seed(int(seed) % (2**63))
  flat = torch.randn(sum(sizes), generator=gen, device=device,
                     dtype=torch.float32).clamp_(-2.0, 2.0)
  out = {}
  for n, part in zip(kernels, torch.split(flat, sizes)):
    std = math.sqrt(1.0 / fans[n]) / _CLIPPED_STD
    out[n] = (part * std).reshape(shapes[n])
  for n, fan in fans.items():
    if fan == 0:
      out[n] = torch.zeros(shapes[n], device=device)
    elif fan < 0:
      out[n] = torch.ones(shapes[n], device=device)
  return out


def load(model: nn.Module, weights: Dict[str, torch.Tensor],
         device) -> nn.Module:
  """``model`` (built on ``meta`` or anywhere) given ``weights`` (copied)
  on ``device``."""
  model.to_empty(device=device)
  model.load_state_dict(weights, strict=True)
  return model
