"""Model and train-state checkpointing: the port of the JAX package's
``utils/checkpoint.py``.

A ``Checkpointer`` keeps ``{prefix}-{epoch}.pt`` and ``{prefix}-{name}.pt``
files in one directory, each a ``torch.save`` of a dict (a module's
``state_dict``, or a full train state: the module's and the optimiser's
``state_dict``, the step and the threefry key), written atomically through
a ``.tmp`` file and ``os.replace``.  ``read_params`` also reads the JAX
package's ``.flax`` parameter files (``utils/flax_msgpack``).
"""

import os
import re
from typing import Any, Optional

import torch
from torch import nn

SUFFIX = ".pt"


def _to_cpu(tree: Any) -> Any:
  """``tree`` with every tensor moved to the CPU (dicts, lists, tuples)."""
  if isinstance(tree, torch.Tensor):
    return tree.detach().cpu()
  if isinstance(tree, dict):
    return {k: _to_cpu(v) for k, v in tree.items()}
  if isinstance(tree, (list, tuple)):
    return type(tree)(_to_cpu(v) for v in tree)
  return tree


def save_file(path: str, state: Any) -> str:
  """``torch.save`` of ``state`` (on the CPU) to ``path`` via ``.tmp``."""
  tmp = path + ".tmp"
  torch.save(_to_cpu(state), tmp)
  os.replace(tmp, path)
  return path


def load_file(path: str, target: Optional[Any] = None) -> Any:
  """The dict saved at ``path`` (tensors on the CPU).  With an
  ``nn.Module`` ``target``, loads it into the module (strictly) and
  returns the module."""
  state = torch.load(path, map_location="cpu", weights_only=True)
  if isinstance(target, nn.Module):
    target.load_state_dict(state, strict=True)
    return target
  return state


class Checkpointer:
  """Saves and loads dicts of tensors keyed by epoch or by name."""

  def __init__(self, ckpt_dir: str, prefix: str = "model") -> None:
    self._ckpt_dir = ckpt_dir
    self._prefix = prefix
    os.makedirs(self._ckpt_dir, exist_ok=True)

  def _path(self, epoch: int) -> str:
    return os.path.join(self._ckpt_dir,
                        "{}-{}{}".format(self._prefix, epoch, SUFFIX))

  def save(self, epoch: int, state: Any) -> str:
    """Saves ``state`` (a ``state_dict`` or a full train state)."""
    return save_file(self._path(epoch), state)

  def load(self, epoch: int, target: Optional[Any] = None) -> Any:
    """The state saved for ``epoch`` (loaded into ``target`` when it is a
    module)."""
    return load_file(self._path(epoch), target)

  def _named_path(self, name: str) -> str:
    return os.path.join(self._ckpt_dir,
                        "{}-{}{}".format(self._prefix, name, SUFFIX))

  def save_named(self, name: str, state: Any) -> str:
    """Saves under a symbolic name (e.g. ``model-best.pt``)."""
    return save_file(self._named_path(name), state)

  def load_named(self, name: str, target: Optional[Any] = None) -> Any:
    return load_file(self._named_path(name), target)

  def has_named(self, name: str) -> bool:
    return os.path.exists(self._named_path(name))

  def latest_epoch(self) -> Optional[int]:
    pattern = re.compile(r"^{}-(\d+){}$".format(re.escape(self._prefix),
                                                re.escape(SUFFIX)))
    epochs = []
    for fname in os.listdir(self._ckpt_dir):
      m = pattern.match(fname)
      if m:
        epochs.append(int(m.group(1)))
    return max(epochs) if epochs else None

  def restore_latest(self, target: Optional[Any] = None) -> Any:
    epoch = self.latest_epoch()
    if epoch is None:
      return None
    return self.load(epoch, target)


def read_params(path: str, module: Optional[nn.Module] = None):
  """A parameter checkpoint of either package: the port's ``.pt`` (a
  ``state_dict``) or the JAX package's ``.flax`` (a flax parameter tree,
  converted by ``models.convert``).  Returns the ``state_dict``, or loads
  it into ``module`` (strictly) and returns the module."""
  if path.endswith(".flax"):
    from oatomobile_torch.models import convert  # pylint: disable=import-outside-toplevel
    from oatomobile_torch.utils import flax_msgpack  # pylint: disable=import-outside-toplevel
    state = convert.state_dict(flax_msgpack.read(path))
  else:
    state = load_file(path)
  if module is None:
    return state
  module.load_state_dict(state, strict=True)
  return module
