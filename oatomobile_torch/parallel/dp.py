"""Training state and the update step on one device: the single-card part
of the JAX package's ``parallel/dp.py``.

The JAX ``TrainState`` is a pytree (params, optimiser state, step, key)
that a jitted update returns anew.  Here the modules and the optimiser are
stateful torch objects that the update changes in place; the step and the
threefry key (``oatomobile_torch.rng``) advance as in the JAX update, so
the noise and dropout draws of step n are JAX's.
"""

import dataclasses
from typing import Any, Callable, List, Optional, Tuple

import torch
from torch import nn

from oatomobile_torch import rng as rng_lib


@dataclasses.dataclass
class TrainState:
  """The modules, their optimiser, the update count and the threefry key
  ``[2]`` of the next update.  ``acc_grads`` and ``mini_step`` hold the
  gradient accumulated over the micro-batches since the last optimiser
  step (``make_update_fn(grad_accum=...)``)."""
  model: nn.Module
  optimizer: torch.optim.Optimizer
  step: int
  rng: torch.Tensor
  acc_grads: Optional[List[torch.Tensor]] = None
  mini_step: int = 0

  @classmethod
  def create(cls, model: nn.Module, optimizer: torch.optim.Optimizer,
             rng: torch.Tensor) -> "TrainState":
    return cls(model=model, optimizer=optimizer, step=0, rng=rng)

  def state_dict(self) -> dict:
    """Everything an exact resume needs (tensors as they are: a
    ``Checkpointer`` moves them to the CPU)."""
    state = {"model": self.model.state_dict(),
             "optimizer": self.optimizer.state_dict(),
             "step": self.step, "rng": self.rng, "mini_step": self.mini_step}
    if self.acc_grads is not None:
      state["acc_grads"] = list(self.acc_grads)
    return state

  def load_state_dict(self, state: dict) -> "TrainState":
    device = self.rng.device
    self.model.load_state_dict(state["model"])
    self.optimizer.load_state_dict(state["optimizer"])
    self.step = int(state["step"])
    self.rng = state["rng"].to(device)
    self.mini_step = int(state.get("mini_step", 0))
    acc = state.get("acc_grads")
    self.acc_grads = (None if acc is None else
                      [a.to(p.device) for a, p in
                       zip(acc, self.model.parameters())])
    return self


def _clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> None:
  """``optax.clip_by_global_norm(max_norm)`` in place: the gradients are
  scaled by ``max_norm / norm`` when their global norm is not below
  ``max_norm``."""
  norm = torch.linalg.vector_norm(
      torch.stack([torch.linalg.vector_norm(g) for g in grads]))
  scale = torch.where(norm < max_norm, torch.ones_like(norm),
                      max_norm / norm)
  for g in grads:
    g.mul_(scale)


def make_update_fn(
    loss_fn: Callable[[nn.Module, Any, torch.Tensor], torch.Tensor],
    clip_norm: Optional[float] = None,
    grad_accum: int = 1,
) -> Callable[[TrainState, Any], Tuple[TrainState, torch.Tensor]]:
  """Builds ``(state, batch) -> (state, loss)``.

  Each call splits ``state.rng`` into the next key and this step's key
  (as the JAX update does), takes the gradient of ``loss_fn(model, batch,
  step_key)`` and steps ``state.optimizer``.  The loss comes back as a
  device scalar: reading it is the caller's synchronisation.

  Args:
    loss_fn: ``(model, batch, rng) -> scalar loss``.
    clip_norm: clip the gradients' global norm to this before the step
      (``optax.chain(optax.clip_by_global_norm(clip_norm), adam)``).
    grad_accum: ``optax.MultiSteps`` semantics: the optimiser steps every
      ``grad_accum``-th call with the running mean of the calls'
      gradients; the other calls only accumulate.
  """

  def update(state: TrainState, batch) -> Tuple[TrainState, torch.Tensor]:
    keys = rng_lib.split(state.rng)
    state.rng, step_rng = keys[0], keys[1]
    state.step += 1
    params = [p for p in state.model.parameters() if p.requires_grad]
    loss = loss_fn(state.model, batch, step_rng)
    grads = list(torch.autograd.grad(loss, params))
    if grad_accum > 1:
      if state.acc_grads is None:
        state.acc_grads = [torch.zeros_like(p) for p in params]
      # Welford's running mean, as optax.MultiSteps accumulates.
      n = state.mini_step
      for acc, g in zip(state.acc_grads, grads):
        acc.add_((g - acc) / (n + 1))
      state.mini_step = (n + 1) % grad_accum
      if state.mini_step:
        return state, loss.detach()
      grads, state.acc_grads = state.acc_grads, None
    if clip_norm is not None:
      _clip_by_global_norm(grads, clip_norm)
    for p, g in zip(params, grads):
      p.grad = g
    state.optimizer.step()
    state.optimizer.zero_grad(set_to_none=True)
    return state, loss.detach()

  return update


def adam(model: nn.Module, learning_rate: float) -> torch.optim.Optimizer:
  """``optax.adam(learning_rate)`` over the model's parameters (b1 0.9, b2
  0.999, eps 1e-8, no weight decay)."""
  return torch.optim.Adam(model.parameters(), lr=learning_rate,
                          betas=(0.9, 0.999), eps=1e-8)
