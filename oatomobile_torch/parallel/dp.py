"""Training state and the data-parallel update step: the port of the JAX
package's ``parallel/dp.py``.

The JAX ``TrainState`` is a pytree (params, optimiser state, step, key)
that a jitted update returns anew.  Here the modules and the optimiser are
stateful torch objects that the update changes in place; the step and the
threefry key (``oatomobile_torch.rng``) advance as in the JAX update, so
the noise and dropout draws of step n are JAX's.

Under a mesh (``parallel.mesh``) every rank takes the loss and gradient of
its ``dp`` rows of the global batch, the gradients are averaged over the
``dp`` group in one flattened all-reduce, and the optimiser steps on the
global gradient, as XLA's psum does under the JAX mesh.
"""

import dataclasses
from typing import Any, Callable, List, Optional, Tuple

import torch
from torch import nn

from oatomobile_torch import rng as rng_lib
from oatomobile_torch.parallel import mesh as mesh_lib
from oatomobile_torch.utils import profiling


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


def _leading_size(tree) -> int:
  """The leading axis of the first array leaf of a batch dict."""
  for value in tree.values():
    if getattr(value, "ndim", 0) >= 1:
      return value.shape[0]
  raise ValueError("a batch with no array leaf")


def _all_reduce_mean_(mesh, grads: List[torch.Tensor]) -> None:
  """The gradients averaged in place over the mesh's ``dp`` group, in
  one flattened buffer (sum / dp size)."""
  flat = torch.cat([g.reshape(-1) for g in grads])
  mesh_lib.all_reduce_sum_(mesh, flat, mesh_lib.DATA_AXIS)
  flat /= mesh.shape[mesh_lib.DATA_AXIS]
  offset = 0
  for g in grads:
    g.copy_(flat[offset:offset + g.numel()].view_as(g))
    offset += g.numel()


def make_update_fn(
    loss_fn: Callable[[nn.Module, Any, torch.Tensor], torch.Tensor],
    clip_norm: Optional[float] = None,
    grad_accum: int = 1,
    mesh=None,
) -> Callable[[TrainState, Any], Tuple[TrainState, torch.Tensor]]:
  """Builds ``(state, batch) -> (state, loss)``.

  Each call splits ``state.rng`` into the next key and this step's key
  (as the JAX update does), takes the gradient of ``loss_fn(model, batch,
  step_key)`` and steps ``state.optimizer``.  The loss comes back as a
  device scalar: reading it is the caller's synchronisation.  A call is
  the span ``update`` with device marks (``utils.profiling``), split into
  ``update.forward`` (to the loss), ``update.backward`` (the gradient and
  its all-reduce) and ``update.optimizer`` (accumulation, clip, step).

  Args:
    loss_fn: ``(model, batch, rng) -> scalar loss``.
    clip_norm: clip the gradients' global norm to this before the step
      (``optax.chain(optax.clip_by_global_norm(clip_norm), adam)``).
    grad_accum: ``optax.MultiSteps`` semantics: the optimiser steps every
      ``grad_accum``-th call with the running mean of the calls'
      gradients; the other calls only accumulate.
    mesh: a ``parallel.mesh.Mesh``: each call takes the global batch (every
      rank the same), keeps this rank's ``dp`` rows (``shard_batch``) and
      runs ``loss_fn`` on them with its draws made at the global shape
      (``mesh.draw_rows``); the gradients are averaged over ``dp`` before
      the accumulation and the clip, which see the global gradient; the
      returned loss is the global one: the world's sum over the ``dp``
      size (the ``dp`` mean, summed over ``mp`` where each ``mp`` rank's
      loss is its members' share of an ensemble's mean).  The module and
      optimiser must already agree over ``dp`` (``replicate_state``).
  """
  sharded = mesh is not None and mesh.device_mesh is not None
  if sharded and clip_norm is not None and \
      mesh.shape[mesh_lib.MODEL_AXIS] > 1:
    raise ValueError("clip_norm over an mp-sharded model is not supported")

  def local_loss(model, batch, step_rng):
    if not sharded:
      return loss_fn(model, batch, step_rng)
    start, stop = mesh_lib.batch_rows(mesh, _leading_size(batch))
    with mesh_lib.global_rows(start, stop, _leading_size(batch)):
      return loss_fn(model, mesh_lib.shard_batch(mesh, batch), step_rng)

  def update(state: TrainState, batch) -> Tuple[TrainState, torch.Tensor]:
    params = [p for p in state.model.parameters() if p.requires_grad]
    dev = params[0].device
    with profiling.span("update", dev):
      keys = rng_lib.split(state.rng)
      state.rng, step_rng = keys[0], keys[1]
      state.step += 1
      with profiling.span("update.forward", dev):
        loss = local_loss(state.model, batch, step_rng)
      with profiling.span("update.backward", dev):
        grads = list(torch.autograd.grad(loss, params))
        if sharded:
          _all_reduce_mean_(mesh, grads)
          loss = mesh_lib.all_reduce_sum_(mesh, loss.detach().clone())
          loss /= mesh.shape[mesh_lib.DATA_AXIS]
      with profiling.span("update.optimizer", dev):
        _optimizer_step(state, params, grads)
    return state, loss.detach()

  def _optimizer_step(state: TrainState, params, grads) -> None:
    if grad_accum > 1:
      if state.acc_grads is None:
        state.acc_grads = [torch.zeros_like(p) for p in params]
      # Welford's running mean, as optax.MultiSteps accumulates.
      n = state.mini_step
      for acc, g in zip(state.acc_grads, grads):
        acc.add_((g - acc) / (n + 1))
      state.mini_step = (n + 1) % grad_accum
      if state.mini_step:
        return
      grads, state.acc_grads = state.acc_grads, None
    if clip_norm is not None:
      _clip_by_global_norm(grads, clip_norm)
    for p, g in zip(params, grads):
      p.grad = g
    state.optimizer.step()
    state.optimizer.zero_grad(set_to_none=True)

  return update


def replicate_state(mesh, state: TrainState) -> TrainState:
  """Broadcasts the model's parameters and buffers, the optimiser's state
  and the key from rank 0 in place, so that every rank starts alike."""
  if mesh is None or mesh.device_mesh is None:
    return state
  with torch.no_grad():
    mesh_lib.replicate(mesh, list(state.model.state_dict().values()))
  for value in state.optimizer.state.values():
    mesh_lib.replicate(mesh, [v for v in value.values()
                              if isinstance(v, torch.Tensor)])
  mesh_lib.replicate(mesh, [state.rng] + list(state.acc_grads or []))
  return state


def adam(model: nn.Module, learning_rate: float) -> torch.optim.Optimizer:
  """``optax.adam(learning_rate)`` over the model's parameters (b1 0.9, b2
  0.999, eps 1e-8, no weight decay)."""
  return torch.optim.Adam(model.parameters(), lr=learning_rate,
                          betas=(0.9, 0.999), eps=1e-8)
