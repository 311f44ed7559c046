"""Multi-layer perceptron: port of the JAX package's ``models/mlp.py``."""

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from perfbench.reference.models import initializers


class MLP(nn.Module):
  """A stack of ``dense_{i}`` layers with an activation between them (and
  after the last with ``activate_final``); dropout between hidden layers in
  training mode only."""

  def __init__(self,
               in_features: int,
               output_sizes: Sequence[int],
               activation_fn: Callable[[torch.Tensor], torch.Tensor] = F.relu,
               dropout_rate: Optional[float] = None,
               activate_final: bool = False,
               *,
               generator: Optional[torch.Generator] = None,
               device="cuda") -> None:
    super().__init__()
    device = torch.device(device)
    self._num_layers = len(output_sizes)
    self._activation_fn = activation_fn
    self._dropout_rate = dropout_rate
    self._activate_final = activate_final
    sizes = (in_features, *output_sizes)
    for i in range(self._num_layers):
      self.add_module("dense_{}".format(i),
                      nn.Linear(sizes[i], sizes[i + 1], device="meta"))
    initializers.materialize(self, generator, device)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    for i in range(self._num_layers):
      x = getattr(self, "dense_{}".format(i))(x)
      is_last = i == self._num_layers - 1
      if not is_last or self._activate_final:
        x = self._activation_fn(x)
        if self._dropout_rate is not None and not is_last:
          x = F.dropout(x, self._dropout_rate, training=self.training)
    return x
