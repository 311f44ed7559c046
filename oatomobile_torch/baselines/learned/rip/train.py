"""Trains the RIP ensemble, K deep imitative models on the same batches:
the port of the JAX package's ``baselines/learned/rip/train.py``.

The JAX trainer stacks the K members' parameters and ``vmap``s one
update over them; here the K members are the modules of one
``nn.ModuleList``, looped over in the loss, with one Adam over all their
parameters (Adam is elementwise, so that is K independent Adams).  Each
step's key splits into K member keys, each member's into its noise and
dropout keys, and the loss is the mean of the members' NLLs, as in the
JAX trainer.  Checkpoints hold the stacked ``state_dict`` (every entry
with a leading member axis); ``unstack_params`` takes member k's.

With ``use_mesh`` and a world of more than one the trainer builds
``ensemble_mesh(num_models)``: each ``mp`` rank trains its ``K / mp``
members (``shard_ensemble``), each under its global member key, on its
``dp`` rows of every batch; the members are gathered in member order
(``gather_ensemble``) for every save and for the returned ensemble.

Run:  python -m oatomobile_torch.baselines.learned.rip.train \\
          --dataset_dir ... --output_dir ... --num_models 4 [--cpu]
"""

import argparse
import os
import time
from typing import Dict, Mapping, Sequence

import torch
from torch import nn

from oatomobile_torch import device as device_lib
from oatomobile_torch import rng as rng_lib
from oatomobile_torch.baselines.learned.dim.train import (
    VELOCITY_DROPOUT, _load_resident, best_val_from_logs, make_context,
    make_loaders, member_nll, rank_loggers, run_epoch, train_mesh, val_mean)
from oatomobile_torch.datasets.carla import CARLADataset
from oatomobile_torch.models.dim import ImitativeModel
from oatomobile_torch.parallel import dp
from oatomobile_torch.parallel import mesh as mesh_lib
from oatomobile_torch.utils.checkpoint import Checkpointer


def stack_params(members: Sequence[nn.Module]) -> Dict[str, torch.Tensor]:
  """The members' ``state_dict``s stacked along a new leading axis."""
  states = [m.state_dict() for m in members]
  return {k: torch.stack([s[k] for s in states]) for k in states[0]}


def unstack_params(stacked: Mapping[str, torch.Tensor],
                   k: int) -> Dict[str, torch.Tensor]:
  """Member k's ``state_dict`` of a stacked ensemble checkpoint."""
  return {name: value[k] for name, value in stacked.items()}


def load_stacked(members: Sequence[nn.Module],
                 stacked: Mapping[str, torch.Tensor]) -> None:
  for k, member in enumerate(members):
    member.load_state_dict(unstack_params(stacked, k))


def make_loss_fn(num_models: int,
                 velocity_dropout: float = VELOCITY_DROPOUT,
                 first_member: int = 0):
  """``(members, batch, rng) -> loss``: the mean over the ``num_models``
  members of each one's NLL under its own key, ``split(rng,
  num_models)[k]`` for member k.  ``members`` (an ``nn.ModuleList``) may
  be a shard of the ensemble, members ``first_member`` on: the loss is
  then their share of the mean (their NLLs' sum / ``num_models``)."""

  def loss_fn(members, batch, rng):
    sample, context = make_context(members[0], batch)
    y = sample["player_future"][..., :2]
    keys = rng_lib.split(rng.to(y.device), num_models)
    nll = torch.stack([
        member_nll(member, y, context, keys[first_member + k],
                   velocity_dropout)
        for k, member in enumerate(members)
    ])
    if len(members) == num_models:
      return nll.mean()
    return nll.sum() / num_models

  return loss_fn


def train(
    dataset_dir: str,
    output_dir: str,
    *,
    num_models: int = 4,
    batch_size: int = 512,
    num_epochs: int = 20,
    learning_rate: float = 1e-3,
    save_model_frequency: int = 4,
    num_timesteps_to_keep: int = 4,
    seed: int = 42,
    max_steps_per_epoch: int = 10**9,
    val_fraction: float = 0.05,
    velocity_dropout: float = VELOCITY_DROPOUT,
    device_data: bool = True,
    grad_accum: int = 1,
    use_mesh: bool = True,
    oversample_restarts: int = 3,
    device="cuda",
) -> nn.ModuleList:
  """Trains the ensemble on ``device``; returns its members.  The held-out
  val NLL (mean over members) selects the ``ensemble-best`` checkpoint.

  ``grad_accum``: each optimiser step averages ``grad_accum`` micro-batches
  of ``batch_size / grad_accum`` samples (``optax.MultiSteps``), the batch
  of ``batch_size`` at a fraction of the activation memory.  ``use_mesh``:
  the ensemble over ``mp`` and the batch over ``dp`` of
  ``ensemble_mesh(num_models)`` with a world of more than one (module
  docstring); rank 0 alone writes the logs and checkpoints.  A run resumes
  from the newest periodic checkpoint in ``output_dir`` (the optimiser
  restarts, the best val loss is read back from the logs); every rank
  loads it, then keeps its members."""
  if grad_accum > 1 and batch_size % grad_accum:
    raise ValueError("batch_size {} is not a multiple of grad_accum "
                     "{}".format(batch_size, grad_accum))
  device = device_lib.resolve(device)
  mesh = train_mesh(use_mesh, device, num_models)
  if mesh is not None:
    device = mesh.device
  os.makedirs(output_dir, exist_ok=True)
  loggers = rank_loggers("rip", os.path.join(output_dir, "logs"))

  ensemble = nn.ModuleList([
      ImitativeModel(output_shape=(num_timesteps_to_keep, 2),
                     generator=torch.Generator().manual_seed(seed + k),
                     device=device) for k in range(num_models)])
  micro_batch = batch_size // max(grad_accum, 1)

  checkpointer = Checkpointer(os.path.join(output_dir, "ckpts"),
                              prefix="ensemble")
  have_val = CARLADataset.is_packed(dataset_dir) and val_fraction > 0
  resident, resident_n = _load_resident(dataset_dir,
                                        device_data and mesh is None, device)
  epoch_loader, val_loader = make_loaders(
      dataset_dir, resident, resident_n, micro_batch, seed, have_val,
      val_fraction, oversample_restarts)

  best_val = float("inf")
  start_epoch = 0
  last = checkpointer.latest_epoch()
  if last is not None:
    load_stacked(ensemble, checkpointer.load(last))
    start_epoch = last + 1
    best_val = best_val_from_logs(output_dir)
    for logger in loggers[:1]:
      logger.write({"resumed_from_epoch": last, "best_val": best_val})

  members, first = ensemble, 0
  if mesh is not None:
    per = num_models // mesh.shape[mesh_lib.MODEL_AXIS]
    first = mesh.coordinate(mesh_lib.MODEL_AXIS) * per
    members = ensemble[first:first + per]
    load_stacked(members, mesh_lib.shard_ensemble(
        mesh, stack_params(ensemble), num_models))

  def stacked_ensemble():
    """Every member's ``state_dict`` stacked in member order."""
    return (stack_params(members) if mesh is None else
            mesh_lib.gather_ensemble(mesh, stack_params(members)))

  loss_fn = make_loss_fn(num_models, velocity_dropout, first)
  update = dp.make_update_fn(loss_fn, grad_accum=grad_accum, mesh=mesh)
  state = dp.TrainState.create(members, dp.adam(members, learning_rate),
                               rng_lib.PRNGKey(seed + 999, device))
  for epoch in range(start_epoch, num_epochs):
    t0 = time.time()
    state, mean_loss = run_epoch(update, state, epoch_loader(epoch),
                                 max_steps_per_epoch)
    record = {"epoch": epoch, "loss": mean_loss, "models": num_models,
              "sec": round(time.time() - t0, 2), "steps": state.step}
    main = mesh_lib.is_main()
    if have_val:
      val = val_mean(loss_fn, members, val_loader, mesh)
      if val is not None:
        record["val_loss"] = val
        if val < best_val:
          best_val = val
          stacked = stacked_ensemble()
          if main:
            checkpointer.save_named("best", stacked)
          record["val_best"] = True
    for logger in loggers:
      logger.write(record)
    if (epoch + 1) % save_model_frequency == 0 or epoch == num_epochs - 1:
      stacked = stacked_ensemble()
      if main:
        checkpointer.save(epoch, stacked)
  for logger in loggers:
    logger.close()
  if mesh is not None:
    load_stacked(ensemble, stacked_ensemble())
  return ensemble


def main() -> None:
  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument("--dataset_dir", required=True)
  parser.add_argument("--output_dir", required=True)
  parser.add_argument("--num_models", type=int, default=4)
  parser.add_argument("--batch_size", type=int, default=512)
  parser.add_argument("--num_epochs", type=int, default=20)
  parser.add_argument("--learning_rate", type=float, default=1e-3)
  parser.add_argument("--seed", type=int, default=42)
  parser.add_argument("--device", default="cuda",
                      help="where to train (default: cuda)")
  parser.add_argument("--cpu", action="store_true",
                      help="train on the CPU (same as --device cpu)")
  args = parser.parse_args()
  train(args.dataset_dir, args.output_dir, num_models=args.num_models,
        batch_size=args.batch_size, num_epochs=args.num_epochs,
        learning_rate=args.learning_rate, seed=args.seed,
        device="cpu" if args.cpu else args.device)


if __name__ == "__main__":
  main()
