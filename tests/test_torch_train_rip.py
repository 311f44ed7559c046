"""One update of the port's RIP trainer (K = 2 members on the same batch)
against the JAX package's on the CPU, with and without gradient
accumulation (``optax.MultiSteps``); the tolerances of
``tests/torch_train_helpers.py``."""

import jax
import numpy as np
import optax
import pytest
import torch

from oatomobile_torch.baselines.learned.rip import train as trip
from oatomobile_torch.models import ImitativeModel, convert
from torch_train_helpers import (INPUT, LOSS_RTOL, LR, check_update,
                                 dim_init, jax_rip_loss, jax_update,
                                 make_batch, mean_tree, port_update)

torch.set_num_threads(1)


def flat(members_sd, k):
  """Member k of a stacked dict, keyed "k.name"."""
  return {"{}.{}".format(k, n): v[k] for n, v in members_sd.items()}


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_rip_update_matches_optax(grad_accum):
  """With ``grad_accum=2``: two micro-batches of 4 and one step."""
  jm = dim_init(0)[0]
  trees = [dim_init(k)[1] for k in range(2)]
  stacked = jax.tree.map(lambda *xs: np.stack(xs), *trees)
  batch = make_batch(8, 3)
  batches = ([batch] if grad_accum == 1 else
             [{k: v[:4] for k, v in batch.items()},
              {k: v[4:] for k, v in batch.items()}])
  tx = optax.adam(LR)
  if grad_accum > 1:
    tx = optax.MultiSteps(tx, every_k_schedule=grad_accum)
  key = np.asarray(jax.random.PRNGKey(42 + 999))
  j_losses, j_grads, j_params = jax_update(jax_rip_loss(jm, 2), stacked,
                                           key, batches, tx)
  members = torch.nn.ModuleList([
      convert.load(ImitativeModel((4, 2), INPUT, device="cpu"), t)
      for t in trees])
  initial = trip.stack_params(members)
  t_losses, t_grads, state = port_update(trip.make_loss_fn(2), members, key,
                                         batches, grad_accum=grad_accum)
  np.testing.assert_allclose(t_losses, j_losses, rtol=LOSS_RTOL)
  assert state.step == len(batches) and state.acc_grads is None
  assert state.mini_step == 0
  j_mean = mean_tree(j_grads)
  got, want, g_port, g_jax, init = {}, {}, {}, {}, {}
  for k in range(2):
    got.update(flat(trip.stack_params(members), k))
    init.update(flat(initial, k))
    want.update({"{}.{}".format(k, n): v for n, v in convert.state_dict(
        jax.tree.map(lambda x, k=k: x[k], j_params)).items()})
    g_jax.update({"{}.{}".format(k, n): v for n, v in convert.state_dict(
        jax.tree.map(lambda x, k=k: x[k], j_mean)).items()})
    g_port.update({"{}.{}".format(k, n[len(str(k)) + 1:]): v
                   for n, v in t_grads.items() if n.startswith(str(k) + ".")})
  excluded = check_update(got, g_port, want, g_jax, init)
  print("grad_accum", grad_accum, "unresolved first-step signs:", excluded)
