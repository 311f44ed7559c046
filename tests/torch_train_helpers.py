"""Helpers of the tests that hold one update of the port's DIM, CIL and RIP
trainers against the JAX package's on the CPU (``test_torch_train*.py``).

Both sides start from the same JAX ``init`` parameters (carried into the
port by ``models.convert``), take the same uint8 batch and the same
threefry key, and make Adam steps at lr 1e-3: the JAX side with the JAX
trainers' losses rebuilt from their modules' functions and ``optax``, the
port with its trainers' ``make_loss_fn`` and ``parallel.dp``.

Tolerances (``check_update``): the loss within 1e-5 relative; each
gradient within 1e-3 of its tensor's largest JAX gradient (flax's
GroupNorm takes the variance as E[x^2] - E[x]^2, which cancels in float32,
and the two libraries sum in other orders); the port's step within rtol
1e-4 / atol 1e-5 of ``optax.adam`` applied to the port's own gradients, at
every element; and the port's updated parameters within rtol 1e-4 / atol
1e-5 of the JAX update at every element but those where Adam's first step,
lr * g / (|g| + eps), takes the sign of a gradient below 1e-3 of its
tensor's largest, which the gradients' float32 differences may flip (at
most 5e-4 of all elements).  The LIDAR is dense: sparse images leave
GroupNorm groups of nearly constant values, whose gradients float32 does
not resolve at all.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax

from oatomobile_torch import rng as rng_lib
from oatomobile_torch.parallel import dp as tdp
from oatomobile_tpu.baselines.learned.cil import train as jcil
from oatomobile_tpu.baselines.learned.dim import train as jdim
from oatomobile_tpu.models.cil import BehaviouralModel as JBehaviouralModel
from oatomobile_tpu.models.dim import ImitativeModel as JImitativeModel

LR = 1e-3
SIZE, INPUT = 64, (32, 32)  # packed LIDAR side and the models' input size
LOSS_RTOL = 1e-5
GRAD_SCALED_ATOL = 1e-3
RTOL, ATOL = 1e-4, 1e-5
UNRESOLVED = 1e-3  # |g| below this of its tensor's largest: sign unresolved
UNRESOLVED_FRACTION = 5e-4


def make_batch(batch: int, seed: int) -> dict:
  """A packed-format batch: dense uint8 LIDAR, forward-moving futures,
  some stopped scenes."""
  rs = np.random.RandomState(seed)
  lidar = rs.randint(0, 256, (batch, SIZE, SIZE, 2))
  speed = rs.uniform(0, 8, (batch, 1)) * (rs.uniform(size=(batch, 1)) < 0.8)
  steps = np.cumsum(rs.uniform(0.5, 1.5, (batch, 80, 3)) * [0.1, 0.02, 0],
                    axis=1) * np.maximum(speed, 0.05)[:, :, None]
  return dict(
      lidar=lidar.astype(np.uint8),
      is_at_traffic_light=rs.randint(0, 2, (batch, 1)).astype(np.float32),
      traffic_light_state=rs.randint(0, 3, (batch, 1)).astype(np.float32),
      velocity=np.concatenate([speed, rs.normal(0, 0.3, (batch, 1)),
                               np.zeros((batch, 1))], -1).astype(np.float32),
      player_future=steps.astype(np.float32))


def numpy_tree(tree):
  return jax.tree.map(np.asarray, tree)


def key_of(seed: int, fold: int = 1) -> np.ndarray:
  """uint32 words of ``fold_in(PRNGKey(seed), fold)`` (the DIM and CIL
  trainers' first key)."""
  return np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed), fold))


def jax_dim_loss(model):
  """The JAX DIM trainer's loss_fn (dim/train.py)."""

  def loss_fn(params, batch, step_rng):
    sample, context = jdim.make_context(model, batch)
    rng_noise, rng_drop = jax.random.split(step_rng)
    context = jdim.dropout_velocity(context, rng_drop,
                                    jdim.VELOCITY_DROPOUT)
    y = sample["player_future"][..., :2]
    y = y + jdim.NOISE_STD * jax.random.normal(rng_noise, y.shape)
    return -jnp.mean(model.apply(params, y, method=model.log_prob,
                                 **context))

  return loss_fn


def jax_cil_loss(model):
  """The JAX CIL trainer's loss_fn (cil/train.py)."""

  def loss_fn(params, batch, step_rng):
    sample, context = jcil.make_context(model, batch)
    context = jdim.dropout_velocity(context, step_rng, jdim.VELOCITY_DROPOUT)
    target = sample["player_future"][..., :2]
    return jnp.mean(jnp.abs(model.apply(params, **context) - target))

  return loss_fn


def jax_rip_loss(model, num_models: int):
  """The JAX RIP trainer's loss_fn over stacked parameters
  (rip/train.py)."""

  def loss_fn(stacked, batch, rng):
    sample, context = jdim.make_context(model, batch)
    y = sample["player_future"][..., :2]

    def member(params_k, rng_k):
      rng_noise, rng_drop = jax.random.split(rng_k)
      ctx_k = jdim.dropout_velocity(context, rng_drop,
                                    jdim.VELOCITY_DROPOUT)
      noisy = y + jdim.NOISE_STD * jax.random.normal(rng_noise, y.shape)
      return -jnp.mean(model.apply(params_k, noisy, method=model.log_prob,
                                   **ctx_k))

    return jnp.mean(jax.vmap(member)(stacked,
                                     jax.random.split(rng, num_models)))

  return loss_fn


def dim_init(seed: int):
  """(JAX ImitativeModel, its init tree as numpy) at the tests' size."""
  model = JImitativeModel((4, 2), INPUT)
  _, ctx = jdim.make_context(model, make_batch(1, 0))
  return model, numpy_tree(model.init(jax.random.PRNGKey(seed),
                                      jnp.zeros((1, 4, 2)),
                                      method=model.log_prob, **ctx))


def cil_init(seed: int):
  """(JAX BehaviouralModel, its init tree as numpy) at the tests' size."""
  model = JBehaviouralModel((40, 2), INPUT)
  _, ctx = jcil.make_context(model, make_batch(1, 0))
  return model, numpy_tree(model.init(jax.random.PRNGKey(seed), **ctx))


def jax_update(loss_fn, params, key, batches, tx):
  """optax steps of ``loss_fn`` over ``batches``, the key split per call
  as the trainers do; returns (losses, each call's grads, params)."""
  params = jax.tree.map(jnp.asarray, params)
  opt_state = tx.init(params)
  rng = jnp.asarray(key)
  losses, grads_list = [], []
  value_and_grad = jax.jit(jax.value_and_grad(loss_fn))
  for batch in batches:
    rng, step_rng = jax.random.split(rng)
    loss, grads = value_and_grad(params, batch, step_rng)
    grads_list.append(numpy_tree(grads))
    updates, opt_state = tx.update(grads, opt_state, params)
    params = optax.apply_updates(params, updates)
    losses.append(float(loss))
  return losses, grads_list, numpy_tree(params)


def port_update(loss_fn, model, key, batches, grad_accum=1):
  """The port's update over ``batches``, which must all come before the
  first optimiser step; returns (losses, the mean of the calls' grads on
  the initial weights, the state)."""
  probe = copy.deepcopy(model)
  rng = rng_lib.from_numpy(key)
  for batch in batches:
    keys = rng_lib.split(rng)
    rng = keys[0]
    loss = loss_fn(probe, batch, keys[1]) / len(batches)
    loss.backward()
  grads = {k: p.grad.clone() for k, p in probe.named_parameters()}
  state = tdp.TrainState.create(model, tdp.adam(model, LR),
                                rng_lib.from_numpy(key))
  update = tdp.make_update_fn(loss_fn, grad_accum=grad_accum)
  losses = []
  for batch in batches:
    state, loss = update(state, batch)
    losses.append(float(loss))
  return losses, grads, state


def mean_tree(trees):
  return jax.tree.map(lambda *xs: sum(xs) / len(xs), *trees)


def scaled(got, want) -> float:
  return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@jax.jit
def _optax_first_step(params, grads):
  opt = optax.adam(LR)
  updates, _ = opt.update(grads, opt.init(params), params)
  return optax.apply_updates(params, updates)


def check_update(port_sd, port_grads, jax_sd, jax_grads, initial_sd) -> int:
  """The tolerances of the module docstring for one Adam step from
  ``initial_sd`` (all dicts of tensors by ``state_dict`` name); returns
  the number of elements with an unresolved first-step sign."""
  assert set(port_sd) == set(jax_sd) == set(jax_grads) == set(port_grads)
  names = sorted(jax_sd)
  optax_step = _optax_first_step(
      {n: jnp.asarray(initial_sd[n].numpy()) for n in names},
      {n: jnp.asarray(port_grads[n].numpy()) for n in names})
  excluded = total = 0
  for name in names:
    got = port_sd[name].numpy()
    g_jax = jax_grads[name].numpy()
    assert scaled(port_grads[name].numpy(), g_jax) <= GRAD_SCALED_ATOL, (
        name, scaled(port_grads[name].numpy(), g_jax))
    np.testing.assert_allclose(got, np.asarray(optax_step[name]),
                               rtol=RTOL, atol=ATOL, err_msg=name)
    off = ~np.isclose(got, jax_sd[name].numpy(), rtol=RTOL, atol=ATOL)
    unresolved = np.abs(g_jax) < UNRESOLVED * np.abs(g_jax).max()
    assert not (off & ~unresolved).any(), name
    excluded += int(off.sum())
    total += off.size
  assert excluded <= UNRESOLVED_FRACTION * total, (excluded, total)
  return excluded
