"""The DIM planner's plain version (``ops/dim_plan_cuda``: the CUDA
kernel's hand-derived backward, autograd's two passes written with tensor
operations) against the plan by ``torch.autograd`` (``best_adam_iterate``
over ``models/dim.posterior_loss``), on the CPU.

The plain version's forward is the model's forward in the same
operations, so its loss and decode equal autograd's bit for bit; its
gradient differs by float32 rounding only (1e-5 of the scene's largest
component), as its GRU cell's backward is the fused kernel's algebra where
the CPU's autograd differentiates the cell's operations one by one.  Adam's first step is ``lr * sign(g)``: every seed here keeps
the first gradient clear of rounding, so the best iterate is the same and
the plans agree to 1e-5 m.
"""

import numpy as np
import pytest
import torch

from oatomobile_torch.models import ImitativeModel
from oatomobile_torch.models import dim
from oatomobile_torch.native import nvcc
from oatomobile_torch.ops import dim_plan_cuda

torch.set_num_threads(1)

GOALS = 10


def model_of(horizon: int = 4) -> ImitativeModel:
  model = ImitativeModel((horizon, 2), (32, 32),
                         generator=torch.Generator().manual_seed(3),
                         device="cpu")
  return model.requires_grad_(False)


@pytest.fixture(scope="module")
def model():
  return model_of()


def inputs(batch: int, seed: int, goal: bool):
  g = torch.Generator().manual_seed(seed)
  z = torch.randn(batch, 64, generator=g) * 0.5
  # Goals as the observation gives them: waypoints [B, K, 3] cut to 2-D.
  goals = (torch.randn(batch, GOALS, 3, generator=g) * 4)[..., :2]
  return z, (goals if goal else None)


def scalars(tensors: bool):
  lr, epsilon = 0.05, 0.8
  if tensors:
    return torch.tensor(lr), torch.tensor(epsilon)
  return lr, epsilon


def autograd_steps(model, z, goal, num_steps, lr, epsilon):
  """``best_adam_iterate``'s loop over ``posterior_loss``, recording each
  iterate, its loss and gradient, and the best iterate's step."""
  loss_fn = dim.posterior_loss(model, z, goal, epsilon)
  x = torch.zeros((z.shape[0],) + model.output_shape)
  mu, nu = torch.zeros_like(x), torch.zeros_like(x)
  x_best, best = x, torch.zeros(z.shape[0], dtype=torch.int32)
  loss_best = torch.full(z.shape[:1], float("inf"))
  trace = []
  for count in range(1, num_steps + 1):
    xg = x.detach().requires_grad_(True)
    loss = loss_fn(xg)
    (g,) = torch.autograd.grad(loss.sum(), xg)
    loss = loss.detach()
    trace.append((x, loss, g))
    update, mu, nu = dim.adam_update(g, mu, nu, count, lr)
    better = loss < loss_best
    x_best = torch.where(better[:, None, None], x, x_best)
    best = torch.where(better, count - 1, best).to(torch.int32)
    loss_best = torch.where(better, loss, loss_best)
    x = x + update
  return model.decode(x_best, z), best, trace


def scene_rel_err(got, want):
  """Per scene: the largest error over the largest |want| component."""
  return ((got - want).abs().amax((1, 2)) /
          want.abs().amax((1, 2))).max().item()


@pytest.mark.parametrize("tensors", [False, True], ids=["numbers", "0d"])
@pytest.mark.parametrize("batch", [1, 5, 64])
@pytest.mark.parametrize("goal", [False, True], ids=["no_goal", "goal"])
def test_gradient_of_every_step_matches_autograd(model, goal, batch,
                                                 tensors):
  z, goals = inputs(batch, 10 + batch, goal)
  lr, epsilon = scalars(tensors)
  weights = dim_plan_cuda.flow_weights(model.decoder)
  _, _, trace = autograd_steps(model, z, goals, 20, lr, epsilon)
  for x, loss_want, g_want in trace:
    loss, g, y = dim_plan_cuda.loss_and_grad(weights, x, z, goals, epsilon)
    assert torch.equal(loss, loss_want)
    assert torch.equal(y, model.decode(x, z))
    assert scene_rel_err(g, g_want) <= 1e-5
  # Adam's first step takes the gradient's sign: each component must be
  # clear of rounding (~1e-7 here), or exactly 0 in both (with no goal,
  # x_{T-1} moves only its own x', which is 0 at x = 0).
  g0 = trace[0][2]
  assert bool(((g0.abs() > 1e-4) | (g0 == 0)).all())
  assert torch.equal(g0 == 0, dim_plan_cuda.loss_and_grad(
      weights, trace[0][0], z, goals, epsilon)[1] == 0)


@pytest.mark.parametrize("num_steps", [1, 5, 20])
@pytest.mark.parametrize("tensors", [False, True], ids=["numbers", "0d"])
@pytest.mark.parametrize("batch", [1, 5, 64])
@pytest.mark.parametrize("goal", [False, True], ids=["no_goal", "goal"])
def test_plan_matches_autograd(model, goal, batch, tensors, num_steps):
  z, goals = inputs(batch, 20 + batch, goal)
  lr, epsilon = scalars(tensors)
  want, best_want, _ = autograd_steps(model, z, goals, num_steps, lr,
                                      epsilon)
  got, best = dim_plan_cuda.plan(dim_plan_cuda.flow_weights(model.decoder),
                                 z, goals, num_steps=num_steps, lr=lr,
                                 epsilon=epsilon, horizon=4)
  assert best.dtype == torch.int32
  assert torch.equal(best, best_want)
  assert (got - want).abs().max().item() <= 1e-5
  # The autograd yardstick is best_adam_iterate's own plan and step.
  plan, step = dim.autograd_plan(model, z, num_steps, goals, lr, epsilon)
  assert torch.equal(want, plan) and torch.equal(best_want, step)


def test_plan_from_z_is_the_plain_version_on_the_cpu(model):
  z, goals = inputs(6, 3, True)
  got = model.plan_from_z(z, num_steps=7, goal=goals, lr=0.05, epsilon=1.0)
  want, _ = dim_plan_cuda.plan_reference(
      dim_plan_cuda.flow_weights(model.decoder), z, goals, num_steps=7,
      lr=0.05, epsilon=1.0, horizon=4)
  assert torch.equal(got, want)
  assert not any(p.grad is not None for p in model.parameters())


@pytest.mark.parametrize("horizon", [1, 2, 8])
def test_other_horizons_match_autograd(horizon):
  model = model_of(horizon)
  z, goals = inputs(4, horizon, True)
  got = model.plan_from_z(z, num_steps=6, goal=goals, lr=0.05, epsilon=1.0)
  want, _ = dim.autograd_plan(model, z, 6, goals, 0.05, 1.0)
  assert got.shape == (4, horizon, 2)
  assert (got - want).abs().max().item() <= 1e-5


def test_no_steps_decode_zeros(model):
  z, goals = inputs(3, 4, True)
  got, best = dim_plan_cuda.plan(dim_plan_cuda.flow_weights(model.decoder),
                                 z, goals, num_steps=0, lr=0.05, epsilon=1.0,
                                 horizon=4)
  assert torch.equal(got, model.decode(torch.zeros(3, 4, 2), z))
  assert torch.equal(got, dim.autograd_plan(model, z, 0, goals, 0.05, 1.0)[0])
  assert (best == 0).all()


def test_the_best_iterate_rule_is_strict(model):
  """With lr 0 every iterate is x = 0 and every loss equal: the strict
  rule keeps the first iterate, as ``best_adam_iterate`` does."""
  z, goals = inputs(5, 5, True)
  got, best = dim_plan_cuda.plan(dim_plan_cuda.flow_weights(model.decoder),
                                 z, goals, num_steps=4, lr=0.0, epsilon=1.0,
                                 horizon=4)
  want, step = dim.autograd_plan(model, z, 4, goals, 0.0, 1.0)
  assert torch.equal(got, want) and torch.equal(best, step)
  assert (best == 0).all()


def test_bias_corrections_are_adam_updates():
  c1, c2 = dim_plan_cuda.bias_corrections(20)
  assert c1.dtype == c2.dtype == np.float32
  for count in (1, 7, 20):
    assert c1[count - 1] == 1 - np.float32(0.9)**np.float32(count)
    assert c2[count - 1] == 1 - np.float32(0.999)**np.float32(count)


def test_the_wrapper_refuses_what_it_does_not_take(model):
  weights = dim_plan_cuda.flow_weights(model.decoder)
  z, goals = inputs(3, 6, True)
  kwargs = dict(num_steps=2, lr=0.05, epsilon=1.0, horizon=4)
  with pytest.raises(TypeError):
    dim_plan_cuda.plan(weights, z.double(), goals, **kwargs)
  with pytest.raises(TypeError):
    dim_plan_cuda.plan(weights, z, goals.double(), **kwargs)
  with pytest.raises(ValueError):
    dim_plan_cuda.plan(weights, z[:, :32], goals, **kwargs)
  with pytest.raises(ValueError):
    dim_plan_cuda.plan(weights, z, goals[:2], **kwargs)
  with pytest.raises(ValueError):
    dim_plan_cuda.plan(weights, z, torch.zeros(3, 10, 3), **kwargs)
  with pytest.raises(ValueError):
    dim_plan_cuda.plan(weights._replace(w_hh=weights.w_hh[:, :32]), z,
                       goals, **kwargs)
  with pytest.raises(ValueError):
    dim_plan_cuda.plan(weights, z, goals,
                       **dict(kwargs, lr=torch.tensor([0.05])))
  with pytest.raises(ValueError):
    dim_plan_cuda.plan(weights, z, goals, **dict(kwargs, horizon=0))
  with pytest.raises(ValueError):  # neither the card nor the CPU
    dim_plan_cuda.plan(weights, z.to("meta"), None, **kwargs)
  assert dim_plan_cuda.KERNEL.launches == 0  # the CPU launches nothing


def test_captured_steps_count_the_planner_kernel():
  assert dim_plan_cuda.KERNEL in nvcc.KERNELS
