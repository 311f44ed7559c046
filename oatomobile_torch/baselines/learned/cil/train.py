"""Trains the behavioural cloning model on expert demonstrations: the port
of the JAX package's ``baselines/learned/cil/train.py``.

L1 loss on the downsampled player_future, the command label derived on
the device from the raw future (signed rule), velocity dropout, Adam lr
1e-3, batch 512, a held-out val L1 every epoch with the best model kept as
``model-best``, checkpoints every 4 epochs, and a resume from the newest
checkpoint.

Run:  python -m oatomobile_torch.baselines.learned.cil.train \\
          --dataset_dir ... --output_dir ... --num_epochs 20 [--cpu]
"""

import argparse
import os
import time

import torch

from oatomobile_torch import device as device_lib
from oatomobile_torch import rng as rng_lib
from oatomobile_torch.baselines.learned.dim.train import (
    MODALITIES, VELOCITY_DROPOUT, _load_resident, as_device_batch,
    best_val_from_logs, dropout_velocity, make_loaders, rank_loggers,
    run_epoch, train_mesh, val_mean)
from oatomobile_torch.datasets.carla import CARLADataset
from oatomobile_torch.models.cil import BehaviouralModel
from oatomobile_torch.parallel import dp
from oatomobile_torch.parallel import mesh as mesh_lib
from oatomobile_torch.utils.checkpoint import Checkpointer


def mode_labels(player_future: torch.Tensor) -> torch.Tensor:
  """Signed command labels [B, 1] from raw future trajectories
  [B, T, >=2]: the tensor twin of ``CARLADataset.derive_mode_labels``
  (signed rule), the eval policy's ``mode_from_goal`` geometry."""
  end = player_future[:, -1, :2]
  norm = torch.linalg.vector_norm(end, dim=-1)
  theta = torch.rad2deg(torch.atan2(end[:, 1], end[:, 0]))
  m = torch.where(theta > 15.0, 3.0, torch.where(theta < -15.0, 2.0, 0.0))
  return torch.where(norm < 3.0, 1.0, m)[:, None]


def make_context(model: BehaviouralModel, batch):
  arrays = as_device_batch(batch, next(model.parameters()).device)
  if "mode" not in arrays and "player_future" in arrays:
    # Device-resident batches carry no host-derived labels; derive them
    # here (before the transform, so that its STOP removal applies).
    arrays["mode"] = mode_labels(arrays["player_future"])
  sample = model.transform(arrays)
  context = {
      "visual_features": sample["visual_features"],
      "velocity": sample["velocity"],
      "is_at_traffic_light": sample["is_at_traffic_light"],
      "traffic_light_state": sample["traffic_light_state"],
      "mode": sample["mode"],
  }
  for key in ("is_at_traffic_light", "traffic_light_state", "mode"):
    if context[key].dim() == 1:
      context[key] = context[key][:, None]
  return sample, context


def make_loss_fn(velocity_dropout: float = VELOCITY_DROPOUT):
  """``(model, batch, rng) -> loss``: the CIL trainer's L1."""

  def loss_fn(model, batch, rng):
    sample, context = make_context(model, batch)
    context = dropout_velocity(context, rng, velocity_dropout)
    target = sample["player_future"][..., :2]
    plan = model(**context)
    return torch.mean(torch.abs(plan - target))

  return loss_fn


def train(
    dataset_dir: str,
    output_dir: str,
    *,
    batch_size: int = 512,
    num_epochs: int = 20,
    learning_rate: float = 1e-3,
    save_model_frequency: int = 4,
    output_length: int = 40,
    seed: int = 42,
    use_mesh: bool = True,
    max_steps_per_epoch: int = 10**9,
    val_fraction: float = 0.05,
    velocity_dropout: float = VELOCITY_DROPOUT,
    device_data: bool = True,
    oversample_restarts: int = 3,
    device="cuda",
) -> dp.TrainState:
  """Runs L1 behavioural-cloning training on ``device``.  A held-out val
  L1 is evaluated every epoch (packed datasets) and the best model is
  saved as ``model-best``; a run resumes from the newest periodic
  checkpoint in ``output_dir`` (the optimiser restarts, the best val loss
  is read back from the logs).  ``use_mesh``: data-parallel over
  ``make_mesh()`` with a world of more than one, as the DIM trainer's."""
  device = device_lib.resolve(device)
  mesh = train_mesh(use_mesh, device)
  if mesh is not None:
    device = mesh.device
  os.makedirs(output_dir, exist_ok=True)
  loggers = rank_loggers("cil", os.path.join(output_dir, "logs"))

  model = BehaviouralModel(output_shape=(output_length, 2),
                           generator=torch.Generator().manual_seed(seed),
                           device=device)
  rng = rng_lib.PRNGKey(seed, device)
  state = dp.TrainState.create(model, dp.adam(model, learning_rate),
                               rng_lib.fold_in(rng, 1))
  loss_fn = make_loss_fn(velocity_dropout)
  update = dp.make_update_fn(loss_fn, mesh=mesh)

  checkpointer = Checkpointer(os.path.join(output_dir, "ckpts"))
  have_val = CARLADataset.is_packed(dataset_dir) and val_fraction > 0
  best_val = float("inf")
  start_epoch = 0
  last = checkpointer.latest_epoch()
  if last is not None:
    checkpointer.load(last, state.model)
    start_epoch = last + 1
    best_val = best_val_from_logs(output_dir)
  state = dp.replicate_state(mesh, state)
  resident, resident_n = _load_resident(dataset_dir,
                                        device_data and mesh is None, device)
  epoch_loader, val_loader = make_loaders(
      dataset_dir, resident, resident_n, batch_size, seed, have_val,
      val_fraction, oversample_restarts, mode=True)

  for epoch in range(start_epoch, num_epochs):
    t0 = time.time()
    state, mean_loss = run_epoch(update, state, epoch_loader(epoch),
                                 max_steps_per_epoch)
    record = {
        "epoch": epoch,
        "loss": mean_loss,
        "sec": round(time.time() - t0, 2),
        "steps": state.step,
    }
    main = mesh_lib.is_main()
    if have_val:
      val = val_mean(loss_fn, state.model, val_loader, mesh)
      if val is not None:
        record["val_loss"] = val
        if val < best_val:
          best_val = val
          if main:
            checkpointer.save_named("best", state.model.state_dict())
          record["val_best"] = True
    for logger in loggers:
      logger.write(record)
    if main and ((epoch + 1) % save_model_frequency == 0 or
                 epoch == num_epochs - 1):
      checkpointer.save(epoch, state.model.state_dict())
  for logger in loggers:
    logger.close()
  return state


def main() -> None:
  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument("--dataset_dir", required=True)
  parser.add_argument("--output_dir", required=True)
  parser.add_argument("--batch_size", type=int, default=512)
  parser.add_argument("--num_epochs", type=int, default=20)
  parser.add_argument("--learning_rate", type=float, default=1e-3)
  parser.add_argument("--save_model_frequency", type=int, default=4)
  parser.add_argument("--seed", type=int, default=42)
  parser.add_argument("--device", default="cuda",
                      help="where to train (default: cuda)")
  parser.add_argument("--cpu", action="store_true",
                      help="train on the CPU (same as --device cpu)")
  args = parser.parse_args()
  train(args.dataset_dir, args.output_dir, batch_size=args.batch_size,
        num_epochs=args.num_epochs, learning_rate=args.learning_rate,
        save_model_frequency=args.save_model_frequency, seed=args.seed,
        device="cpu" if args.cpu else args.device)


if __name__ == "__main__":
  main()
