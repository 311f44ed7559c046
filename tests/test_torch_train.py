"""One update of the port's DIM and CIL trainers against the JAX
package's on the CPU (the tolerances of ``tests/torch_train_helpers.py``),
the GRU's hidden biases through an update, and the trainers' small
functions."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from oatomobile_torch import rng as rng_lib
from oatomobile_torch.baselines.learned.cil import train as tcil
from oatomobile_torch.baselines.learned.dim import train as tdim
from oatomobile_torch.baselines.learned.rip import train as trip
from oatomobile_torch.models import BehaviouralModel, ImitativeModel, convert
from oatomobile_tpu.baselines.learned.cil import train as jcil
from oatomobile_tpu.baselines.learned.dim import train as jdim
from torch_train_helpers import (ATOL, INPUT, LOSS_RTOL, LR, RTOL,
                                 check_update, cil_init, dim_init,
                                 jax_cil_loss, jax_dim_loss, jax_update,
                                 key_of, make_batch, port_update)

torch.set_num_threads(1)


def one_update(jax_loss, port_loss, tree, port_model, batch_seed):
  batch = make_batch(8, batch_seed)
  key = key_of(42)
  j_losses, j_grads, j_params = jax_update(jax_loss, tree, key, [batch],
                                           optax.adam(LR))
  model = convert.load(port_model, tree)
  initial = {k: v.clone() for k, v in model.state_dict().items()}
  t_losses, t_grads, state = port_update(port_loss, model, key, [batch])
  return dict(j_losses=j_losses, j_grads=convert.state_dict(j_grads[0]),
              j_sd=convert.state_dict(j_params), t_losses=t_losses,
              t_grads=t_grads, state=state, initial=initial, key=key)


@pytest.fixture(scope="module")
def updates():
  jm, tree = dim_init(0)
  dim = one_update(jax_dim_loss(jm), tdim.make_loss_fn(), tree,
                   ImitativeModel((4, 2), INPUT, device="cpu"), 1)
  jm, tree = cil_init(0)
  cil = one_update(jax_cil_loss(jm), tcil.make_loss_fn(), tree,
                   BehaviouralModel((40, 2), INPUT, device="cpu"), 2)
  return {"dim": dim, "cil": cil}


@pytest.mark.parametrize("which", ["dim", "cil"])
def test_one_update_matches_optax(which, updates):
  out = updates[which]
  np.testing.assert_allclose(out["t_losses"], out["j_losses"],
                             rtol=LOSS_RTOL)
  state = out["state"]
  excluded = check_update(state.model.state_dict(), out["t_grads"],
                          out["j_sd"], out["j_grads"], out["initial"])
  print(which, "elements with an unresolved first-step sign:", excluded)
  # The key advanced as the JAX update's: split, keep the first.
  np.testing.assert_array_equal(
      rng_lib.to_numpy(state.rng),
      np.asarray(jax.random.split(jnp.asarray(out["key"]))[0]))
  assert state.step == 1


@pytest.mark.parametrize("which", ["dim", "cil"])
def test_gru_hidden_biases_stay_zero_after_an_update(which, updates):
  """flax's GRUCell has no r and z hidden biases: after an Adam step of
  the trainer the port's r and z hidden biases are still exactly 0, and
  its GRU parameters equal the JAX update's."""
  out = updates[which]
  model = out["state"].model
  gru = model.decoder.gru if which == "dim" else model.gru
  prefix = "decoder.gru." if which == "dim" else "gru."
  h = gru.hidden_size
  assert torch.equal(gru.bias_hh[:2 * h].detach(), torch.zeros(2 * h))
  sd = model.state_dict()
  gru_keys = [k for k in sd if k.startswith(prefix)]
  assert sum(sd[k].numel() for k in gru_keys) == sum(
      out["j_sd"][k].numel() for k in gru_keys)
  for key in gru_keys:
    assert not torch.equal(sd[key], out["initial"][key]), key
    np.testing.assert_allclose(sd[key].numpy(), out["j_sd"][key].numpy(),
                               rtol=RTOL, atol=ATOL, err_msg=key)


def test_stack_and_unstack_params():
  members = [ImitativeModel((4, 2), INPUT, device="cpu",
                            generator=torch.Generator().manual_seed(k))
             for k in range(3)]
  stacked = trip.stack_params(members)
  assert all(v.shape[0] == 3 for v in stacked.values())
  for k, member in enumerate(members):
    one = trip.unstack_params(stacked, k)
    for name, value in member.state_dict().items():
      assert torch.equal(one[name], value), name


def test_mode_labels_match_jax():
  rs = np.random.RandomState(4)
  future = rs.normal(0, 10, (64, 80, 3)).astype(np.float32)
  future[:4, -1, :2] = [[20.0, 0.0], [1.0, 1.0], [15.0, 10.0], [15.0, -10.0]]
  want = np.asarray(jcil.mode_labels_jnp(jnp.asarray(future)))
  got = tcil.mode_labels(torch.from_numpy(future)).numpy()
  np.testing.assert_array_equal(got, want)
  assert set(np.unique(got)) == {0.0, 1.0, 2.0, 3.0}


def test_dropout_velocity_matches_jax():
  rs = np.random.RandomState(5)
  velocity = rs.normal(size=(256, 3)).astype(np.float32)
  key = jax.random.PRNGKey(7)
  want = np.asarray(jdim.dropout_velocity(
      {"velocity": jnp.asarray(velocity)}, key, 0.25)["velocity"])
  got = tdim.dropout_velocity({"velocity": torch.from_numpy(velocity)},
                              rng_lib.from_numpy(np.asarray(key)),
                              0.25)["velocity"].numpy()
  np.testing.assert_array_equal(got, want)
  assert 0 < (got[:, 0] == 0).sum() < 256
  assert tdim.nll_limit((4, 2)) == jdim.nll_limit((4, 2))
