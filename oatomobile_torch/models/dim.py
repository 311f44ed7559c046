"""The Deep Imitative Model (DIM): port of the JAX package's
``models/dim.py``.

MobileNetV2(2ch) -> concat(velocity, is_at_traffic_light,
traffic_light_state) -> MLP[64, 64, 64] -> z; the decoder is the
autoregressive flow; ``plan`` optimises the base sample of a trajectory
under the imitation prior and the goal likelihood with Adam.

The JAX package runs the plan's Adam steps as a ``lax.scan`` of
``optax.adam`` updates.  Here ``plan_from_z`` runs them all in one launch
of a hand-written CUDA kernel on the card, or its plain PyTorch version on
the CPU (``ops/dim_plan_cuda``: the flow's forward, a hand-derived
backward, Adam in optax's order, the best iterate).  ``autograd_plan`` is
the same plan as a Python loop of ``adam_update`` with the gradient from
``torch.autograd.grad`` (``best_adam_iterate`` over ``posterior_loss``):
the yardstick that both are held against, and the pattern of RIP's
aggregated plan.
"""

from typing import Callable, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from oatomobile_torch import device as device_lib
from oatomobile_torch.models import initializers, transforms
from oatomobile_torch.models.mlp import MLP
from oatomobile_torch.models.perception import MobileNetV2
from oatomobile_torch.models.sequence import LOG_2PI, AutoregressiveFlow
from oatomobile_torch.ops import dim_plan_cuda

CONTEXT_KEYS = ("visual_features", "velocity", "is_at_traffic_light",
                "traffic_light_state")


def check_context(context: Mapping[str, torch.Tensor], keys) -> None:
  for key in keys:
    if key not in context:
      raise ValueError("Missing `{}` keyword argument.".format(key))


def adam_update(g: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
                count: int, lr, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8, eps_root: float = 0.0):
  """One ``optax.adam(lr)`` step: returns (update, mu, nu).  ``count`` is
  the step's number counted from 1 (optax increments before the bias
  correction); ``lr`` a number or a 0-d tensor."""
  mu = (1 - b1) * g + b1 * mu
  nu = (1 - b2) * g**2 + b2 * nu
  mu_hat = mu / (1 - np.float32(b1)**np.float32(count))
  nu_hat = nu / (1 - np.float32(b2)**np.float32(count))
  update = (mu_hat / (torch.sqrt(nu_hat + eps_root) + eps)) * (-lr)
  return update, mu, nu


def best_adam_iterate(loss_fn: Callable[[torch.Tensor], torch.Tensor],
                      x0: torch.Tensor, num_steps: int,
                      lr) -> torch.Tensor:
  """Runs ``num_steps`` Adam steps on ``x0`` ([B, ...]) against the
  per-scene loss ``loss_fn(x)`` ([B]) and returns, per scene, the iterate
  whose loss was lowest.  The best loss starts at +inf, so the first
  evaluated iterate always becomes the incumbent; an iterate is the one
  evaluated before its update.

  The gradient is taken under ``torch.enable_grad()`` even when the caller
  holds ``no_grad``; it is the gradient of ``x`` only, and writes no
  ``.grad``.  Adam's step count is a Python number: a captured step
  unrolls the loop, so each plan step keeps its own bias correction."""
  x = x0
  mu, nu = torch.zeros_like(x0), torch.zeros_like(x0)
  x_best = x0
  loss_best = torch.full(x0.shape[:1], float("inf"), dtype=torch.float32,
                         device=x0.device)
  expand = (slice(None),) + (None,) * (x0.dim() - 1)
  for count in range(1, num_steps + 1):
    with torch.enable_grad():
      xg = x.detach().requires_grad_(True)
      loss = loss_fn(xg)
      (g,) = torch.autograd.grad(loss.sum(), xg)
    loss = loss.detach()
    update, mu, nu = adam_update(g, mu, nu, count, lr)
    better = loss < loss_best
    x_best = torch.where(better[expand], x, x_best)
    loss_best = torch.where(better, loss, loss_best)
    x = x + update
  return x_best


def goal_likelihood(y: torch.Tensor, goal: torch.Tensor,
                    epsilon=1.0) -> torch.Tensor:
  """Per-scene [B] log-likelihood of the plan endpoint ``y[..., -1, :]``
  under an equal mixture of isotropic normals (scale ``epsilon``, a number
  or a 0-d tensor) at the K goals ``goal`` [B, K, D]."""
  _, K, D = goal.shape
  diff = y[..., -1, :][:, None, :] - goal  # [B, K, D]
  log_epsilon = (torch.log(epsilon) if isinstance(epsilon, torch.Tensor)
                 else float(np.log(np.float32(epsilon))))
  comp_logp = (-0.5 * ((diff / epsilon)**2).sum(-1) - D * log_epsilon -
               0.5 * D * LOG_2PI)
  return (torch.logsumexp(comp_logp, dim=-1) -
          float(np.log(np.float32(K))))


def posterior_loss(model: "ImitativeModel", z: torch.Tensor,
                   goal: Optional[torch.Tensor] = None,
                   epsilon=1.0) -> Callable[[torch.Tensor], torch.Tensor]:
  """The plan's loss ``x -> [B]``: the per-scene negative imitation
  posterior of ``decode(x, z)`` (the prior, plus the goal likelihood
  where ``goal`` is given), differentiable by autograd."""

  def loss_fn(x):
    y = model.decode(x, z)
    loss = model.imitation_prior_from_z(y, z)
    if goal is not None:
      loss = loss + goal_likelihood(y, goal, epsilon=epsilon)
    return -loss

  return loss_fn


def autograd_plan(model: "ImitativeModel", z: torch.Tensor,
                  num_steps: int = 10, goal: Optional[torch.Tensor] = None,
                  lr=1e-1, epsilon=1.0):
  """``plan_from_z`` by ``best_adam_iterate`` over ``posterior_loss``: the
  plan as autograd computes it (~7,000 kernels at 20 steps on a card), the
  yardstick of the planner kernel and its plain version.  Returns (plan
  [B, T, 2], the best iterate's step [B] int32, counted from 0)."""
  loss_fn, losses = posterior_loss(model, z, goal, epsilon), []

  def recorded(x):
    loss = loss_fn(x)
    losses.append(loss.detach())
    return loss

  x0 = torch.zeros(z.shape[:1] + model.output_shape, dtype=torch.float32,
                   device=z.device)
  x_best = best_adam_iterate(recorded, x0, num_steps, lr)
  # The strict rule from +inf: the first lowest loss, NaN never chosen.
  step = (torch.stack(losses).nan_to_num(nan=float("inf")).argmin(0)
          if losses else torch.zeros(z.shape[:1], device=z.device))
  return model.decode(x_best, z), step.to(torch.int32)


class ImitativeModel(nn.Module):
  """Conditional density estimator p(trajectory | context).

  ``input_size`` is the encoder's visual input resolution (100x100 in the
  reference).  Context: ``visual_features`` [B, 2, H, W] (NCHW, from
  ``transform``), ``velocity`` [B, 3], ``is_at_traffic_light`` [B, 1],
  ``traffic_light_state`` [B, 1].
  """

  def __init__(self,
               output_shape: Tuple[int, int] = (4, 2),
               input_size: Tuple[int, int] = (100, 100),
               *,
               generator: Optional[torch.Generator] = None,
               device="cuda") -> None:
    super().__init__()
    device = device_lib.resolve(device)
    self.output_shape = tuple(output_shape)
    self.input_size = tuple(input_size)
    self.encoder = MobileNetV2(in_channels=2, num_classes=128,
                               device="meta")
    self.merger = MLP(128 + 3 + 1 + 1, (64, 64, 64), activate_final=True,
                      device="meta")
    self.decoder = AutoregressiveFlow(self.output_shape, hidden_size=64,
                                      device="meta")
    initializers.materialize(self, generator, device)

  # -- context encoding ------------------------------------------------------

  def params_z(self, **context: torch.Tensor) -> torch.Tensor:
    """Contextual parameters z [B, 64] of the conditional flow."""
    check_context(context, CONTEXT_KEYS)
    features = self.encoder(context["visual_features"])
    features = torch.cat([
        features,
        context["velocity"],
        context["is_at_traffic_light"],
        context["traffic_light_state"],
    ], dim=-1)
    return self.merger(features)

  # -- densities --------------------------------------------------------------

  def log_prob(self, y: torch.Tensor, **context: torch.Tensor) -> torch.Tensor:
    """Exact log-likelihood [B] of trajectories y [B, T, 2]."""
    return self.imitation_prior_from_z(y, self.params_z(**context))

  def imitation_prior_from_z(self, y: torch.Tensor,
                             z: torch.Tensor) -> torch.Tensor:
    """Per-scene imitation prior [B]."""
    _, log_prob, logabsdet = self.decoder._inverse(y, z)  # pylint: disable=protected-access
    return log_prob - logabsdet

  def decode(self, x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    return self.decoder._forward(x, z)[0]  # pylint: disable=protected-access

  def sample(self, generator: torch.Generator,
             **context: torch.Tensor) -> torch.Tensor:
    """Stochastic trajectory samples (the decoder's push-forward)."""
    return self.decoder(self.params_z(**context), generator)

  goal_likelihood = staticmethod(goal_likelihood)

  # -- planning ------------------------------------------------------------------

  def plan(self,
           num_steps: int = 10,
           goal: Optional[torch.Tensor] = None,
           lr=1e-1,
           epsilon=1.0,
           **context: torch.Tensor) -> torch.Tensor:
    """A local mode [B, T, 2] of the imitation posterior: ``num_steps``
    Adam steps from the prior mean (zeros), the best iterate decoded.
    ``lr`` and ``epsilon`` are numbers or 0-d tensors (a captured step
    reads them from its buffers)."""
    if "visual_features" not in context:
      raise ValueError("Missing `visual_features` keyword argument.")
    z = self.params_z(**context)
    return self.plan_from_z(z, num_steps=num_steps, goal=goal, lr=lr,
                            epsilon=epsilon)

  def plan_from_z(self,
                  z: torch.Tensor,
                  num_steps: int = 10,
                  goal: Optional[torch.Tensor] = None,
                  lr=1e-1,
                  epsilon=1.0) -> torch.Tensor:
    """``plan`` from a precomputed context encoding z [B, 64] (so the
    encoder may run at another precision while the planner stays f32):
    one launch of the planner kernel for CUDA tensors, its plain version
    for CPU tensors (``ops/dim_plan_cuda.plan``, which raises on what the
    kernel does not take).  The plan is not differentiable."""
    return dim_plan_cuda.plan(dim_plan_cuda.flow_weights(self.decoder), z,
                              goal, num_steps=num_steps, lr=lr,
                              epsilon=epsilon,
                              horizon=self.output_shape[0])[0]

  # -- preprocessing ---------------------------------------------------------------

  def transform(
      self, sample: Mapping[str, torch.Tensor]) -> Mapping[str, torch.Tensor]:
    """Prepares raw sample variables for the model: ``lidar`` (or
    ``visual_features``) NHWC images become NCHW ``visual_features``."""
    sample = dict(sample)
    if "player_future" in sample:
      sample["player_future"] = transforms.downsample_target(
          sample["player_future"],
          num_timesteps_to_keep=self.output_shape[-2])
    if "lidar" in sample:
      sample["visual_features"] = sample.pop("lidar")
    if "visual_features" in sample:
      sample["visual_features"] = transforms.prepare_visual_features(
          sample["visual_features"], self.input_size)
    return sample
