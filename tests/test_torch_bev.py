"""The port's BEV splat against the JAX package's: the kernel inputs
(``gather_inputs``), the plain dense splat, and the plain version of the
CUDA kernel (``splat_lidar_batch_reference``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oatomobile_torch import sim as tsim
from oatomobile_torch.maps import load_town as torch_load_town
from oatomobile_torch.ops import bev as tbev
from oatomobile_torch.ops import bev_cuda
from oatomobile_torch.sim import types as ttypes
from oatomobile_tpu import sim as jsim
from oatomobile_tpu.maps import load_town as jax_load_town
from oatomobile_tpu.ops import bev as jbev
from oatomobile_tpu.ops import bev_pallas
from torch_port_helpers import fraction_beyond, jax_state_to_numpy

torch.set_num_threads(1)

# Pixel values: the "above" counts table and the ground ring are float32
# images that the two libraries compute with their own transcendental
# functions (last-ulp differences, ~3e-7 on values <= 1): atol 1e-6.
VALUE_ATOL = 1e-6
# Occupancy: a pixel whose centre lies within float rounding of a rect
# edge may fall either side when two computations round differently (FMA
# contraction in XLA, world-frame boxes in the kernel against hero-frame
# boxes in the dense splat).  The JAX package bounds such pixels below
# 1e-4 (tests/test_sensors_extra.py); so does this file.
EDGE_FRACTION = 1e-4

# (town, vehicles, pedestrians, steps of motion, seed): the cases of
# tests/test_bev_pallas.py plus a town with curved geometry and walkers.
CASES = [("Town02", 0, 0, 0, 7), ("Town02", 6, 3, 0, 7),
         ("Town02", 4, 0, 25, 9), ("Town03", 8, 4, 20, 11)]


def _scenes(town, num_vehicles, num_pedestrians, steps, seed):
  jt = jax_load_town(town)
  jp = jsim.make_params(jt)
  states = jsim.init_scene_batch(jt, 3, num_vehicles=num_vehicles,
                                 num_pedestrians=num_pedestrians, seed=seed)
  step = jax.jit(jax.vmap(jsim.world_step, in_axes=(None, 0, 0)))
  actions = jnp.tile(jnp.asarray([0.8, 0.3, 0.0]), (3, 1))
  for _ in range(steps):
    states = step(jp, states, actions)
  tp = tsim.make_params(torch_load_town(town), device="cpu")
  ts = ttypes.scene_state_from_numpy(jax_state_to_numpy(states), "cpu")
  return jp, states, tp, ts


@pytest.fixture(scope="module", params=CASES,
                ids=lambda c: "{}-{}v-{}p-{}s".format(*c[:4]))
def scenes(request):
  return _scenes(*request.param)


@pytest.fixture(scope="module")
def pallas(scenes):
  """The TPU kernel the CUDA kernel replaces, in interpret mode."""
  jp, states, _, _ = scenes
  return np.asarray(bev_pallas.splat_lidar_pallas(jp, states,
                                                  interpret=True))


def test_gather_inputs_match(scenes):
  jp, states, tp, ts = scenes
  want = jax.vmap(lambda s: bev_pallas.gather_inputs(jp, s))(states)
  got = tbev.gather_inputs(tp, ts)
  names = ("hero", "walls", "roads", "boxes")
  for name, w, g in zip(names, want, got):
    w, g = np.asarray(w), g.numpy()
    assert g.shape == w.shape and g.dtype == w.dtype, name
  hero_w, walls_w, roads_w, boxes_w = (np.asarray(x) for x in want)
  hero_g, walls_g, roads_g, boxes_g = (x.numpy() for x in got)
  # Selections, positions and extents are gathered data: exact.
  np.testing.assert_array_equal(walls_g, walls_w)
  np.testing.assert_array_equal(roads_g, roads_w)
  np.testing.assert_array_equal(hero_g[:, :2], hero_w[:, :2])
  np.testing.assert_array_equal(boxes_g[..., :4], boxes_w[..., :4])
  # cos/sin of a yaw: XLA's and torch's CPU sin/cos differ in the last
  # ulp (<= 6e-8 on [-1, 1]); two ulps allowed.
  np.testing.assert_allclose(hero_g[:, 2:], hero_w[:, 2:], rtol=0,
                             atol=1.2e-7)
  np.testing.assert_allclose(boxes_g[..., 4:], boxes_w[..., 4:], rtol=0,
                             atol=1.2e-7)


def test_dense_splat_matches_jax_dense_and_pallas(scenes, pallas):
  jp, states, tp, ts = scenes
  got = tbev.splat_lidar(tp, ts).numpy()
  assert got.shape == (3, 200, 200, 2) and got.dtype == np.float32
  dense = np.asarray(
      jax.vmap(lambda s: jbev.splat_lidar(jp, s, method="dense"))(states))
  assert fraction_beyond(got, dense, VALUE_ATOL) < EDGE_FRACTION
  assert fraction_beyond(got, pallas, VALUE_ATOL) < EDGE_FRACTION
  # A real scene: walls, open ground and (with actors) obstacles appear.
  assert (got[..., 0] > 0).mean() > 0.01 and (got[..., 1] > 0).any()


def test_dense_splat_matches_jax_interval(scenes):
  # The JAX sensor's default method: the interval form.
  jp, states, tp, ts = scenes
  got = tbev.splat_lidar(tp, ts).numpy()
  interval = np.asarray(jax.vmap(lambda s: jbev.splat_lidar(jp, s))(states))
  assert fraction_beyond(got, interval, VALUE_ATOL) < EDGE_FRACTION


def test_kernel_reference_matches_plain_splat_and_pallas(scenes, pallas):
  _, _, tp, ts = scenes
  inputs = tbev.gather_inputs(tp, ts)
  ref = bev_cuda.splat_lidar_batch_reference(*inputs).numpy()
  assert fraction_beyond(ref, tbev.splat_lidar(tp, ts).numpy(),
                         VALUE_ATOL) < EDGE_FRACTION
  assert fraction_beyond(ref, pallas, VALUE_ATOL) < EDGE_FRACTION
  # On CPU tensors the kernel wrapper runs exactly the plain version.
  np.testing.assert_array_equal(bev_cuda.splat_lidar_batch(*inputs).numpy(),
                                ref)
