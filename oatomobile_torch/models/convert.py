"""Carries weights of the JAX package's flax models into the port's modules.

``state_dict(tree)`` turns a flax parameter tree of numpy arrays
(``{"params": {...}}`` as ``model.init`` returns it, with every leaf
passed through ``numpy.asarray``) into a ``state_dict`` of the port's
module of the same name (``ImitativeModel``, ``BehaviouralModel``, or any
of their parts): the port names its submodules as flax names its scopes.
Each leaf is used exactly once; a leaf of an unknown layout raises.

Layouts:
- Conv ``kernel`` HWIO -> ``weight`` OIHW (a depthwise ``(3, 3, 1, C)``
  becomes ``(C, 1, 3, 3)``, the conv having ``groups=C``);
- Dense ``kernel`` (in, out) -> ``weight`` (out, in); ``bias`` as is;
- GroupNorm ``scale`` -> ``weight``; ``bias`` as is;
- GRUCell (denses ``ir, iz, in`` with biases, ``hr, hz`` without, ``hn``
  with) -> ``weight_ih = cat[ir, iz, in].T``, ``bias_ih = cat[b_ir, b_iz,
  b_in]``, ``weight_hh = cat[hr, hz, hn].T``, ``bias_hn = b_hn``
  (``models.sequence.GRUCell``: flax's parameters, no more).

Needs numpy only: no jax.
"""

from typing import Dict, Mapping, Sequence

import numpy as np
import torch
from torch import nn

_GRU_GATES = ("ir", "iz", "in", "hr", "hz", "hn")


def _tensor(x) -> torch.Tensor:
  return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))


def _gru(node: Mapping, prefix: str, out: Dict[str, torch.Tensor]) -> int:
  """GRU cell entries of ``out`` from its six gate denses; returns the
  number of leaves used."""
  if set(node) != set(_GRU_GATES):
    raise ValueError("{}: not a GRUCell: {}".format(prefix, sorted(node)))
  for gate in ("hr", "hz"):
    if set(node[gate]) != {"kernel"}:
      raise ValueError("{}.{}: expected a bias-free dense".format(prefix, gate))
  for gate in ("ir", "iz", "in", "hn"):
    if set(node[gate]) != {"kernel", "bias"}:
      raise ValueError("{}.{}: expected kernel and bias".format(prefix, gate))
  kernels = lambda gates: np.concatenate(  # pylint: disable=unnecessary-lambda-assignment
      [np.asarray(node[g]["kernel"]) for g in gates], axis=1).T
  out[prefix + "weight_ih"] = _tensor(kernels(("ir", "iz", "in")))
  out[prefix + "weight_hh"] = _tensor(kernels(("hr", "hz", "hn")))
  out[prefix + "bias_ih"] = _tensor(np.concatenate(
      [np.asarray(node[g]["bias"]) for g in ("ir", "iz", "in")]))
  out[prefix + "bias_hn"] = _tensor(node["hn"]["bias"])
  return 10


def _layer(node: Mapping, prefix: str, out: Dict[str, torch.Tensor]) -> int:
  """Entries of one Conv, Dense or GroupNorm layer; returns the number of
  leaves used."""
  keys = set(node)
  if keys in ({"kernel"}, {"kernel", "bias"}):
    kernel = np.asarray(node["kernel"])
    if kernel.ndim == 4:
      out[prefix + "weight"] = _tensor(kernel.transpose(3, 2, 0, 1))
    elif kernel.ndim == 2:
      out[prefix + "weight"] = _tensor(kernel.T)
    else:
      raise ValueError("{}kernel: rank {}".format(prefix, kernel.ndim))
  elif keys == {"scale", "bias"}:
    out[prefix + "weight"] = _tensor(node["scale"])
  else:
    raise ValueError("{}: unknown layer layout {}".format(prefix,
                                                          sorted(keys)))
  if "bias" in keys:
    out[prefix + "bias"] = _tensor(node["bias"])
  return len(keys)


def _walk(node: Mapping, prefix: str, out: Dict[str, torch.Tensor]) -> int:
  if set(node) == set(_GRU_GATES):
    return _gru(node, prefix, out)
  if all(not isinstance(v, Mapping) for v in node.values()):
    return _layer(node, prefix, out)
  used = 0
  for name, child in node.items():
    if not isinstance(child, Mapping):
      raise ValueError("{}{}: a leaf beside scopes".format(prefix, name))
    used += _walk(child, prefix + name + ".", out)
  return used


def count_leaves(node) -> int:
  if isinstance(node, Mapping):
    return sum(count_leaves(v) for v in node.values())
  return 1


def state_dict(tree: Mapping) -> Dict[str, torch.Tensor]:
  """The port's ``state_dict`` (float32 CPU tensors) of a flax tree."""
  params = tree["params"] if "params" in tree else tree
  out: Dict[str, torch.Tensor] = {}
  used = _walk(params, "", out)
  if used != count_leaves(params):
    raise ValueError("used {} of the tree's {} leaves".format(
        used, count_leaves(params)))
  return out


def load(module: nn.Module, tree: Mapping) -> nn.Module:
  """Loads a flax tree into ``module`` (strictly: every parameter of the
  module and every leaf of the tree); returns the module."""
  module.load_state_dict(state_dict(tree), strict=True)
  return module


def load_ensemble(models: Sequence[nn.Module],
                  trees: Sequence[Mapping]) -> Sequence[nn.Module]:
  """Loads K flax trees (a RIP ensemble's members) into K modules."""
  if len(models) != len(trees):
    raise ValueError("{} models for {} trees".format(len(models), len(trees)))
  return [load(m, t) for m, t in zip(models, trees)]
