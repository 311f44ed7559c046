"""Trains the deep imitative model on expert demonstrations: the port of
the JAX package's ``baselines/learned/dim/train.py``.

NLL objective -(log_prob - logabsdet) on noised targets (sigma 1e-2),
per-sample velocity dropout, Adam lr 1e-3, batch 512, a held-out val NLL
every epoch with the best model kept as ``model-best``, checkpoints every 4
epochs, the full train state for an exact resume, and stopped->restart
oversampling.  The noise and dropout draws come from the same threefry
keys as the JAX trainer's (``oatomobile_torch.rng``).

Run:  python -m oatomobile_torch.baselines.learned.dim.train \\
          --dataset_dir ... --output_dir ... --num_epochs 20 [--cpu]
"""

import argparse
import json
import os
import time

import numpy as np
import torch

from oatomobile_torch import device as device_lib
from oatomobile_torch import rng as rng_lib
from oatomobile_torch.datasets.carla import CARLADataset
from oatomobile_torch.models.dim import ImitativeModel
from oatomobile_torch.parallel import dp
from oatomobile_torch.parallel import mesh as mesh_lib
from oatomobile_torch.utils.checkpoint import Checkpointer
from oatomobile_torch.utils.loggers import JSONLLogger, TerminalLogger

MODALITIES = (
    "lidar",
    "is_at_traffic_light",
    "traffic_light_state",
    "player_future",
    "velocity",
)

NOISE_STD = 1e-2  # target perturbation
VELOCITY_DROPOUT = 0.25  # per-sample velocity-context dropout (see below)

# Device-resident datasets larger than this stream from the host instead
# (leave device memory for the model, the optimiser and the activations).
_DEVICE_DATA_BYTES_CAP = 6 * 1024**3


def _load_resident(dataset_dir: str, enabled: bool, device):
  """(data, num_samples) when the packed dataset should live on
  ``device`` (under the size cap), else (None, 0)."""
  if not (enabled and CARLADataset.is_packed(dataset_dir)):
    return None, 0
  # Size check via memory-mapped headers (no load) before any upload.
  with open(os.path.join(dataset_dir, "manifest.json")) as fp:
    manifest = json.load(fp)
  nbytes = 0
  for key in manifest["modalities"]:
    if key in MODALITIES:
      arr = np.load(os.path.join(dataset_dir, "{}.npy".format(key)),
                    mmap_mode="r")
      nbytes += int(arr.size) * arr.dtype.itemsize
  if nbytes > _DEVICE_DATA_BYTES_CAP:
    return None, 0
  return CARLADataset.load_packed_to_device(dataset_dir, MODALITIES,
                                            device=device)


def dropout_velocity(context, rng: torch.Tensor, rate: float):
  """Zeroes the velocity context for a random ``rate`` fraction of samples
  (``jax.random.bernoulli(rng, 1 - rate, (B, 1))``: a uniform draw below
  ``1 - rate`` keeps a sample's velocity).

  Counter-measure for the imitation "inertia problem": a model whose
  predicted future speed tracks its input speed is only marginally stable
  in closed loop.  Dropping the speed input for a fraction of training
  samples makes the model also infer motion from the visual context.
  """
  if rate <= 0.0:
    return context
  velocity = context["velocity"]
  keep = (mesh_lib.draw_rows(rng_lib.uniform, rng.to(velocity.device),
                             (velocity.shape[0], 1)) < 1.0 - rate)
  return dict(context, velocity=velocity * keep.to(torch.float32))


def nll_limit(output_shape, noise_std: float = NOISE_STD) -> float:
  """Theoretical NLL lower bound for noise-perturbed targets: the
  differential entropy of the added Gaussian, 0.5 * D * (log(2 pi
  sigma^2) + 1), negative for sigma = 1e-2."""
  D = int(np.prod(output_shape))
  return float(0.5 * D * (np.log(2 * np.pi * noise_std**2) + 1.0))


def _device_of(model: torch.nn.Module) -> torch.device:
  return next(model.parameters()).device


def as_device_batch(batch, device) -> dict:
  """A batch (numpy arrays or tensors) as tensors on ``device``; uint8
  images become float32 / 255 there."""
  out = {}
  for key, value in batch.items():
    value = torch.as_tensor(value, device=device)
    out[key] = (value.to(torch.float32) / 255.0 if value.dtype == torch.uint8
                else value)
  return out


def make_context(model: ImitativeModel, batch):
  """Applies ``model.transform`` (NHWC LIDAR -> NCHW visual features) and
  extracts the context keyword arguments."""
  sample = model.transform(as_device_batch(batch, _device_of(model)))
  context = {
      "visual_features": sample["visual_features"],
      "velocity": sample["velocity"],
      "is_at_traffic_light": sample["is_at_traffic_light"],
      "traffic_light_state": sample["traffic_light_state"],
  }
  for key in ("is_at_traffic_light", "traffic_light_state"):
    if context[key].dim() == 1:
      context[key] = context[key][:, None]
  return sample, context


def member_nll(model: ImitativeModel, y: torch.Tensor, context,
               rng: torch.Tensor, velocity_dropout: float) -> torch.Tensor:
  """One model's NLL of the noised targets ``y`` [B, T, 2]: the key splits
  into the noise key and the dropout key, as in the JAX trainer."""
  keys = rng_lib.split(rng.to(y.device))
  context = dropout_velocity(context, keys[1], velocity_dropout)
  noisy = y + NOISE_STD * mesh_lib.draw_rows(rng_lib.normal, keys[0],
                                             y.shape)
  return -torch.mean(model.log_prob(noisy, **context))


def make_loss_fn(velocity_dropout: float = VELOCITY_DROPOUT):
  """``(model, batch, rng) -> loss``: the DIM trainer's NLL."""

  def loss_fn(model, batch, rng):
    sample, context = make_context(model, batch)
    y = sample["player_future"][..., :2]
    return member_nll(model, y, context, rng, velocity_dropout)

  return loss_fn


def eval_loss(loss_fn, model, batch) -> torch.Tensor:
  """The loss of a batch under the fixed key ``PRNGKey(0)``, no grad."""
  with torch.no_grad():
    return loss_fn(model, batch, rng_lib.PRNGKey(0, _device_of(model)))


def restart_oversampled(dataset_dir: str, num_samples: int, split,
                        val_fraction: float, oversample: int) -> np.ndarray:
  """The split's indices with its stopped->restart samples
  (``CARLADataset.restart_transition_indices``) tiled ``oversample`` more
  times."""
  idx = CARLADataset.packed_split_indices(num_samples, split,
                                          val_fraction=val_fraction)
  if oversample <= 0:
    return idx
  restart_idx = np.intersect1d(
      CARLADataset.restart_transition_indices(dataset_dir), idx)
  if not len(restart_idx):  # pylint: disable=g-explicit-length-test
    return idx
  return np.concatenate([idx] + [restart_idx] * oversample)


def make_loaders(dataset_dir: str, resident, resident_n: int,
                 batch_size: int, seed: int, have_val: bool,
                 val_fraction: float, oversample_restarts: int,
                 mode: bool = False):
  """(epoch_loader(epoch), val_loader()) of the trainers: device gathers
  from the resident pack, else the streaming numpy loader."""
  split = "train" if have_val else None
  train_idx = None
  if resident is not None:
    train_idx = restart_oversampled(dataset_dir, resident_n, split,
                                    val_fraction, oversample_restarts)

  def epoch_loader(epoch):
    if resident is not None:
      return CARLADataset.iter_device_batches(resident, train_idx,
                                              batch_size, seed=seed + epoch)
    return CARLADataset.make_loader(
        dataset_dir, MODALITIES, batch_size=batch_size, mode=mode,
        seed=seed + epoch, split=split, val_fraction=val_fraction)

  def val_loader():
    if resident is not None:
      idx = CARLADataset.packed_split_indices(resident_n, "val",
                                              val_fraction=val_fraction)
      return CARLADataset.iter_device_batches(resident, idx, batch_size,
                                              shuffle=False,
                                              drop_remainder=False)
    return CARLADataset.make_loader(dataset_dir, MODALITIES,
                                    batch_size=batch_size, mode=mode,
                                    split="val", val_fraction=val_fraction)

  return epoch_loader, val_loader


def run_epoch(update, state, loader, max_steps: int):
  """Runs the epoch's updates; returns (state, mean loss or nan)."""
  losses = []
  for i, batch in enumerate(loader):
    if i >= max_steps:
      break
    state, loss = update(state, batch)
    losses.append(loss)
  mean = float(torch.stack(losses).mean()) if losses else float("nan")
  return state, mean


def val_mean(loss_fn, model, val_loader, mesh=None):
  """Mean loss over the val batches, or None without any.  Under a mesh
  every rank evaluates the whole of each val batch, and the losses are
  summed over ``mp`` (an ensemble's members' shares), so the value is the
  global mean on every rank."""
  losses = [eval_loss(loss_fn, model, batch) for batch in val_loader()]
  if not losses:
    return None
  losses = torch.stack(losses)
  if mesh is not None:
    mesh_lib.all_reduce_sum_(mesh, losses, mesh_lib.MODEL_AXIS)
  return float(losses.mean())


def train_mesh(use_mesh: bool, device, num_models: int = 0):
  """The trainers' mesh: with ``use_mesh`` and a world of more than one,
  ``make_mesh`` (``ensemble_mesh(num_models)`` for an ensemble) on
  ``device``; else None, and the trainer runs its one-device code."""
  if not use_mesh or mesh_lib.world_size() == 1:
    return None
  if num_models:
    return mesh_lib.ensemble_mesh(num_models, device=device)
  return mesh_lib.make_mesh(device=device)


def rank_loggers(label: str, log_dir: str, tensorboard: bool = False):
  """The terminal and JSONL loggers (and TensorBoard's) on the rank that
  writes files, none on the others."""
  if not mesh_lib.is_main():
    return []
  loggers = [TerminalLogger(label=label),
             JSONLLogger(log_dir, "{}_train".format(label))]
  if tensorboard:
    from oatomobile_torch.utils.loggers import TensorBoardLogger  # pylint: disable=import-outside-toplevel
    loggers.append(TensorBoardLogger(os.path.join(log_dir, "tb"),
                                     label=label))
  return loggers


def best_val_from_logs(output_dir: str) -> float:
  """The lowest ``val_loss`` of the JSONL training logs (inf without)."""
  best = float("inf")
  log_dir = os.path.join(output_dir, "logs")
  for name in (sorted(os.listdir(log_dir)) if os.path.isdir(log_dir)
               else ()):
    if not name.endswith(".jsonl"):
      continue
    with open(os.path.join(log_dir, name)) as fp:
      for line in fp:
        try:
          rec = json.loads(line)
        except ValueError:
          continue
        if "val_loss" in rec and rec["val_loss"] < best:
          best = rec["val_loss"]
  return best


def train(
    dataset_dir: str,
    output_dir: str,
    *,
    batch_size: int = 512,
    num_epochs: int = 20,
    learning_rate: float = 1e-3,
    save_model_frequency: int = 4,
    num_timesteps_to_keep: int = 4,
    clip_gradients: bool = False,
    seed: int = 42,
    use_mesh: bool = True,
    max_steps_per_epoch: int = 10**9,
    resume: bool = False,
    plot_every: int = 4,
    val_fraction: float = 0.05,
    tensorboard: bool = False,
    velocity_dropout: float = VELOCITY_DROPOUT,
    device_data: bool = True,
    input_size=(100, 100),
    oversample_restarts: int = 3,
    device="cuda",
) -> dp.TrainState:
  """Runs training on ``device``; returns the final TrainState.

  Args:
    use_mesh: with a world of more than one (torchrun, or a process group
      the caller started), data-parallel over ``make_mesh()``: every rank
      reads the same batches, takes its ``dp`` rows and averages the
      gradients; the pack is not resident on the card then, and rank 0
      alone writes logs, checkpoints and plots.  A world of one runs the
      one-device code.
    resume: restore the latest full train state (model, optimiser, step,
      key) from output_dir/state: an exact resume.
    plot_every: if > 0, draw sampled plans over the BEV input of a fixed
      batch every N epochs into output_dir/plots (matplotlib).
    val_fraction: held-out validation fraction (packed datasets only);
      the val NLL is evaluated every epoch and the best model is saved as
      ``model-best``.
    device_data: keep the packed dataset resident on the device (under
      the size cap) and gather batches there.
    device: ``"cuda"`` unless the caller asks for ``"cpu"`` (under a
      mesh, this rank's card).
  """
  device = device_lib.resolve(device)
  mesh = train_mesh(use_mesh, device)
  if mesh is not None:
    device = mesh.device
  os.makedirs(output_dir, exist_ok=True)
  loggers = rank_loggers("dim", os.path.join(output_dir, "logs"),
                         tensorboard)

  model = ImitativeModel(output_shape=(num_timesteps_to_keep, 2),
                         input_size=tuple(input_size),
                         generator=torch.Generator().manual_seed(seed),
                         device=device)
  rng = rng_lib.PRNGKey(seed, device)
  state = dp.TrainState.create(model, dp.adam(model, learning_rate),
                               rng_lib.fold_in(rng, 1))
  loss_fn = make_loss_fn(velocity_dropout)
  update = dp.make_update_fn(loss_fn,
                             clip_norm=1.0 if clip_gradients else None,
                             mesh=mesh)

  have_val = CARLADataset.is_packed(dataset_dir) and val_fraction > 0
  resident, resident_n = _load_resident(dataset_dir,
                                        device_data and mesh is None, device)
  epoch_loader, val_loader = make_loaders(
      dataset_dir, resident, resident_n, batch_size, seed, have_val,
      val_fraction, oversample_restarts)

  state_ckpt = Checkpointer(os.path.join(output_dir, "state"),
                            prefix="train_state")
  start_epoch = 0
  if resume:
    latest = state_ckpt.latest_epoch()
    if latest is not None:
      state.load_state_dict(state_ckpt.load(latest))
      start_epoch = latest + 1
  state = dp.replicate_state(mesh, state)

  checkpointer = Checkpointer(os.path.join(output_dir, "ckpts"))
  limit = nll_limit((num_timesteps_to_keep, 2))
  best_val = float("inf")
  peek = None  # the batch the plots draw, read at the first plot

  for epoch in range(start_epoch, num_epochs):
    t0 = time.time()
    state, mean_loss = run_epoch(update, state, epoch_loader(epoch),
                                 max_steps_per_epoch)
    record = {
        "epoch": epoch,
        "loss": mean_loss,
        "nll_limit": limit,
        "sec": round(time.time() - t0, 2),
        "steps": state.step,
    }
    val = (val_mean(loss_fn, state.model, val_loader, mesh) if have_val
           else None)
    main = mesh_lib.is_main()
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
      state_ckpt.save(epoch, state.state_dict())
    if main and plot_every and (epoch + 1) % plot_every == 0:
      if peek is None:
        peek = next(iter(CARLADataset.make_loader(
            dataset_dir, MODALITIES, batch_size=2, seed=seed)))
      _plot_samples(state.model, peek, output_dir, epoch)
  for logger in loggers:
    logger.close()
  return state


def _plot_samples(model: ImitativeModel, batch, output_dir: str,
                  epoch: int) -> None:
  """One sampled plan and the ground truth over the first sample's BEV
  input, saved as output_dir/plots/epoch_<epoch>.png."""
  from oatomobile_torch.utils import graphics  # pylint: disable=import-outside-toplevel
  with torch.no_grad():
    sample, context = make_context(model, batch)
    plans = model.sample(torch.Generator().manual_seed(epoch), **context)
  target = sample["player_future"][..., :2]
  plot_dir = os.path.join(output_dir, "plots")
  os.makedirs(plot_dir, exist_ok=True)
  bev = sample["visual_features"][0].movedim(0, -1)  # CHW -> HWC
  graphics.plot_trajectory_overlay(
      bev.cpu().numpy(),
      {"sample": plans[0].cpu().numpy(),
       "ground_truth": target[0].cpu().numpy()},
      output_fname=os.path.join(plot_dir, "epoch_{}.png".format(epoch)))


def main() -> None:
  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument("--dataset_dir", required=True)
  parser.add_argument("--output_dir", required=True)
  parser.add_argument("--batch_size", type=int, default=512)
  parser.add_argument("--num_epochs", type=int, default=20)
  parser.add_argument("--learning_rate", type=float, default=1e-3)
  parser.add_argument("--save_model_frequency", type=int, default=4)
  parser.add_argument("--num_timesteps_to_keep", type=int, default=4)
  parser.add_argument("--clip_gradients", action="store_true")
  parser.add_argument("--seed", type=int, default=42)
  parser.add_argument("--resume", action="store_true")
  parser.add_argument("--plot_every", type=int, default=4)
  parser.add_argument("--val_fraction", type=float, default=0.05)
  parser.add_argument("--tensorboard", action="store_true")
  parser.add_argument("--device", default="cuda",
                      help="where to train (default: cuda)")
  parser.add_argument("--cpu", action="store_true",
                      help="train on the CPU (same as --device cpu)")
  args = parser.parse_args()
  train(args.dataset_dir, args.output_dir, batch_size=args.batch_size,
        num_epochs=args.num_epochs, learning_rate=args.learning_rate,
        save_model_frequency=args.save_model_frequency,
        num_timesteps_to_keep=args.num_timesteps_to_keep,
        clip_gradients=args.clip_gradients, seed=args.seed,
        resume=args.resume, plot_every=args.plot_every,
        val_fraction=args.val_fraction, tensorboard=args.tensorboard,
        device="cpu" if args.cpu else args.device)


if __name__ == "__main__":
  main()
