"""The reference of the DIM trainer's first updates: the batches' rows
worked out from the raw data and the loader's rules, the NLL with its
noise and velocity-dropout draws, its gradients and Adam, in plain
PyTorch, eagerly.

A frozen copy of the program's loss (``baselines/learned/dim/train.py``)
over the reference's own model, draws and Adam (optax's ``adam``: b1 0.9,
b2 0.999, eps 1e-8, bias-corrected moments).
"""

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from perfbench.reference import threefry
from perfbench.reference.models.dim import ImitativeModel

NOISE_STD = 1e-2
B1, B2, EPS = 0.9, 0.999, 1e-8


# --- the loader's rows ------------------------------------------------------


def split_indices(n: int, split: str, val_fraction: float,
                  split_seed: int = 1234) -> np.ndarray:
  """The packed split: the last ``val_fraction`` of a fixed permutation is
  the validation set."""
  perm = np.random.RandomState(split_seed).permutation(n)
  num_val = max(1, int(round(n * val_fraction)))
  return np.sort(perm[:-num_val]) if split == "train" else np.sort(
      perm[-num_val:])


def restart_indices(velocity: np.ndarray, player_future: np.ndarray,
                    speed_thresh: float = 1.0,
                    move_thresh: float = 2.0) -> np.ndarray:
  """Samples stopped (ego speed below ``speed_thresh``) whose expert
  future leaves a ``move_thresh``-metre disc."""
  speed = np.linalg.norm(np.asarray(velocity[:, :2], np.float32), axis=-1)
  disp = np.linalg.norm(np.asarray(player_future[:, -1, :2], np.float32),
                        axis=-1)
  return np.where((speed < speed_thresh) & (disp > move_thresh))[0]


def epoch_batches(n: int, velocity: np.ndarray, player_future: np.ndarray,
                  *, batch_size: int, seed: int, epoch: int,
                  val_fraction: float, oversample: int) -> List[np.ndarray]:
  """The rows of each batch of an epoch: the train split with its
  stopped->restart samples tiled ``oversample`` more times, shuffled by
  ``RandomState(seed + epoch)``, cut into full batches, each sorted."""
  idx = split_indices(n, "train", val_fraction)
  restart = np.intersect1d(restart_indices(velocity, player_future), idx)
  order = (np.concatenate([idx] + [restart] * oversample)
           if oversample > 0 and len(restart) else idx).copy()
  np.random.RandomState(seed + epoch).shuffle(order)
  stop = len(order) - len(order) % batch_size
  return [np.sort(order[s:s + batch_size])
          for s in range(0, stop, batch_size)]


# --- the loss ------------------------------------------------------------------


def _context(model: ImitativeModel, batch: Dict[str, torch.Tensor]):
  sample = {k: (v.to(torch.float32) / 255.0 if v.dtype == torch.uint8
                else v) for k, v in batch.items()}
  sample = model.transform(sample)
  context = {k: sample[k] for k in ("visual_features", "velocity",
                                    "is_at_traffic_light",
                                    "traffic_light_state")}
  for key in ("is_at_traffic_light", "traffic_light_state"):
    if context[key].dim() == 1:
      context[key] = context[key][:, None]
  return sample, context


def nll(model: ImitativeModel, batch: Dict[str, torch.Tensor],
        rng: torch.Tensor, velocity_dropout: float) -> torch.Tensor:
  """The DIM trainer's loss: the mean NLL of the noised targets, with a
  share ``velocity_dropout`` of the samples' velocity zeroed; the key
  splits into the noise key and the dropout key."""
  sample, context = _context(model, batch)
  y = sample["player_future"][..., :2]
  keys = threefry.split(rng.to(y.device))
  if velocity_dropout > 0.0:
    v = context["velocity"]
    keep = threefry.uniform(keys[1], (v.shape[0], 1)) < 1.0 - velocity_dropout
    context = dict(context, velocity=v * keep.to(torch.float32))
  noisy = y + NOISE_STD * threefry.normal(keys[0], y.shape)
  return -torch.mean(model.log_prob(noisy, **context))


# --- the updates ---------------------------------------------------------------


def follow(model: ImitativeModel, batches: Sequence[Dict[str, torch.Tensor]],
           rng: torch.Tensor, lr: float, velocity_dropout: float):
  """Steps ``model`` (its weights the program's initial ones) through one
  Adam update a batch, each with the key schedule of the program's update
  (split the state's key: the first half is the next state's key, the
  second this step's).  Returns (losses, first gradients by name)."""
  names = [n for n, _ in model.named_parameters()]
  params = [p for _, p in model.named_parameters()]
  mu = [torch.zeros_like(p) for p in params]
  nu = [torch.zeros_like(p) for p in params]
  losses, first = [], None
  for count, batch in enumerate(batches, start=1):
    keys = threefry.split(rng)
    rng, step_rng = keys[0], keys[1]
    loss = nll(model, batch, step_rng, velocity_dropout)
    grads = torch.autograd.grad(loss, params)
    if first is None:
      first = {n: g.detach().clone() for n, g in zip(names, grads)}
    losses.append(float(loss.detach()))
    # Adam written out: p -= lr * m_hat / (sqrt(v_hat) + eps), the bias
    # corrections folded into the step size and the denominator.
    with torch.no_grad():
      for p, g, m, v in zip(params, grads, mu, nu):
        m.lerp_(g, 1 - B1)
        v.mul_(B2).addcmul_(g, g, value=1 - B2)
        denom = (v.sqrt() / math.sqrt(1 - B2**count)).add_(EPS)
        p.addcdiv_(m, denom, value=-lr / (1 - B1**count))
  return losses, first
