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
    make_loaders, member_nll, run_epoch, val_mean)
from oatomobile_torch.datasets.carla import CARLADataset
from oatomobile_torch.models.dim import ImitativeModel
from oatomobile_torch.parallel import dp
from oatomobile_torch.utils.checkpoint import Checkpointer
from oatomobile_torch.utils.loggers import JSONLLogger, TerminalLogger


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
                 velocity_dropout: float = VELOCITY_DROPOUT):
  """``(members, batch, rng) -> loss``: the mean over the ``num_models``
  members (an ``nn.ModuleList``) of each one's NLL under its own key."""

  def loss_fn(members, batch, rng):
    sample, context = make_context(members[0], batch)
    y = sample["player_future"][..., :2]
    keys = rng_lib.split(rng.to(y.device), num_models)
    return torch.stack([
        member_nll(member, y, context, keys[k], velocity_dropout)
        for k, member in enumerate(members)
    ]).mean()

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
  of ``batch_size`` at a fraction of the activation memory.  ``use_mesh``
  has no effect: one device.  A run resumes from the newest periodic
  checkpoint in ``output_dir`` (the optimiser restarts, the best val loss
  is read back from the logs)."""
  del use_mesh
  if grad_accum > 1 and batch_size % grad_accum:
    raise ValueError("batch_size {} is not a multiple of grad_accum "
                     "{}".format(batch_size, grad_accum))
  device = device_lib.resolve(device)
  os.makedirs(output_dir, exist_ok=True)
  loggers = [TerminalLogger(label="rip"),
             JSONLLogger(os.path.join(output_dir, "logs"), "rip_train")]

  members = nn.ModuleList([
      ImitativeModel(output_shape=(num_timesteps_to_keep, 2),
                     generator=torch.Generator().manual_seed(seed + k),
                     device=device) for k in range(num_models)])
  micro_batch = batch_size // max(grad_accum, 1)
  loss_fn = make_loss_fn(num_models, velocity_dropout)
  update = dp.make_update_fn(loss_fn, grad_accum=grad_accum)

  checkpointer = Checkpointer(os.path.join(output_dir, "ckpts"),
                              prefix="ensemble")
  have_val = CARLADataset.is_packed(dataset_dir) and val_fraction > 0
  resident, resident_n = _load_resident(dataset_dir, device_data, device)
  epoch_loader, val_loader = make_loaders(
      dataset_dir, resident, resident_n, micro_batch, seed, have_val,
      val_fraction, oversample_restarts)

  best_val = float("inf")
  start_epoch = 0
  last = checkpointer.latest_epoch()
  if last is not None:
    load_stacked(members, checkpointer.load(last))
    start_epoch = last + 1
    best_val = best_val_from_logs(output_dir)
    loggers[0].write({"resumed_from_epoch": last, "best_val": best_val})
  state = dp.TrainState.create(members, dp.adam(members, learning_rate),
                               rng_lib.PRNGKey(seed + 999, device))
  for epoch in range(start_epoch, num_epochs):
    t0 = time.time()
    state, mean_loss = run_epoch(update, state, epoch_loader(epoch),
                                 max_steps_per_epoch)
    record = {"epoch": epoch, "loss": mean_loss, "models": num_models,
              "sec": round(time.time() - t0, 2), "steps": state.step}
    if have_val:
      val = val_mean(loss_fn, members, val_loader)
      if val is not None:
        record["val_loss"] = val
        if val < best_val:
          best_val = val
          checkpointer.save_named("best", stack_params(members))
          record["val_best"] = True
    for logger in loggers:
      logger.write(record)
    if (epoch + 1) % save_model_frequency == 0 or epoch == num_epochs - 1:
      checkpointer.save(epoch, stack_params(members))
  for logger in loggers:
    logger.close()
  return members


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
