"""oatomobile_torch.sensors.synth against oatomobile_tpu.sensors.synth on
the CPU: the state sensors, the goal sensor, the actor tracker and the
bird-view renders from the same scene state (the cameras and the
game-state masks: tests/test_torch_cameras.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oatomobile_torch import sim as tsim
from oatomobile_torch.maps import load_town as torch_load_town
from oatomobile_torch.sensors import synth as tsynth
from oatomobile_torch.sim import types as ttypes
from oatomobile_tpu import sim as jsim
from oatomobile_tpu.maps import load_town as jax_load_town
from oatomobile_tpu.sensors import synth as jsynth
from torch_port_helpers import jax_state_to_numpy

torch.set_num_threads(1)

KEYS = jsynth.STATE_SENSORS + ("red_light_invasion", "actors_tracker")
# cos/sin/rad2deg of a yaw and the ego-frame rotation of the goal points:
# XLA's and torch's CPU transcendentals differ in the last ulp, and XLA
# contracts x*y + z into an FMA.  On goal offsets of ~20 m and angles in
# degrees that is a few 1e-6; 1e-5 bounds it.
ATOL = 1e-5


@pytest.fixture(scope="module", params=[("Town02", 6, 2), ("Town03", 8, 4)],
                ids=lambda c: "{}-{}v-{}p".format(*c))
def scenes(request):
  town, num_vehicles, num_pedestrians = request.param
  jt = jax_load_town(town)
  jp = jsim.make_params(jt)
  states = jsim.init_scene_batch(jt, 3, num_vehicles=num_vehicles,
                                 num_pedestrians=num_pedestrians, seed=2)
  policy = jax.jit(jax.vmap(lambda s: jsim.autopilot_policy(jp, s)))
  step = jax.jit(jax.vmap(jsim.world_step, in_axes=(None, 0, 0)))
  # Move off the spawns so speeds, goals and light states are non-trivial.
  for _ in range(40):
    action, states = policy(states)
    states = step(jp, states, action)
  tp = tsim.make_params(torch_load_town(town), device="cpu")
  ts = ttypes.scene_state_from_numpy(jax_state_to_numpy(states), "cpu")
  return jp, states, tp, ts


def test_state_sensors_match(scenes):
  jp, states, tp, ts = scenes
  want = jax.vmap(lambda s: jsynth.synthesize(jp, s, KEYS))(states)
  got = tsynth.synthesize(tp, ts, KEYS)
  assert set(got) == set(want)
  for key in KEYS:
    w, g = np.asarray(want[key]), got[key].numpy()
    assert g.shape == w.shape and g.dtype == w.dtype, key
    if w.dtype.kind == "f":
      np.testing.assert_allclose(g, w, rtol=0, atol=ATOL, err_msg=key)
    else:
      np.testing.assert_array_equal(g, w, err_msg=key)
  assert float(jnp.abs(want["velocity"]).max()) > 0.5


BIRD_VIEW_KEYS = ("bird_view_camera_rgb", "bird_view_camera_cityscapes")
# A bird-view pixel takes the class of the raster cell or box its centre
# falls in; XLA's FMA and the last ulp of cos/sin move a centre lying on a
# cell or box edge to the other side: under 1e-3 of the pixels.
BIRD_VIEW_PIXEL_FRACTION = 1e-3


@pytest.mark.parametrize("key", BIRD_VIEW_KEYS)
def test_bird_view_matches(scenes, key):
  jp, states, tp, ts = scenes
  want = np.asarray(jax.vmap(
      lambda s: jsynth.synthesize(jp, s, (key,)))(states)[key])
  got = tsynth.synthesize(tp, ts, (key,))[key].numpy()
  assert got.shape == want.shape == (3, 200, 200, 3)
  assert got.dtype == want.dtype
  differing = np.any(got != want, axis=-1).mean()
  assert differing < BIRD_VIEW_PIXEL_FRACTION, differing
  # Ground, road, lane line, building and hero colours all appear.
  assert len(np.unique(want.reshape(-1, 3), axis=0)) >= 5


def test_bird_view_axis_is_jnp_linspace():
  half, size = jsynth.BIRD_VIEW_METERS, jsynth.BIRD_VIEW_SIZE
  want = np.asarray(jnp.linspace(-half + half / size, half - half / size,
                                 size))
  got = tsynth._bird_view_axis("cpu").numpy()  # pylint: disable=protected-access
  # XLA rounds start * (1 - t) + stop * t its own way: a few ulps of the
  # 25 m half-width, far below a raster cell (0.1 m or more).
  np.testing.assert_allclose(got, want, rtol=0, atol=4e-6)


def test_bird_view_classes_draw_actors():
  """NPCs and pedestrians placed around the hero show as their classes:
  the box test against the JAX package's, exactly."""
  jt = jax_load_town("Town03")
  jp = jsim.make_params(jt)
  states = jsim.init_scene_batch(jt, 2, num_vehicles=6, num_pedestrians=6,
                                 seed=3)
  rs = np.random.RandomState(0)
  hero = np.asarray(states.hero_xy)[:, None, :]
  states = states.replace(
      npc_xy=jnp.asarray(hero + rs.uniform(-15, 15, (2, 6, 2)),
                         jnp.float32),
      npc_yaw=jnp.asarray(rs.uniform(-3, 3, (2, 6)), jnp.float32),
      ped_xy=jnp.asarray(hero + rs.uniform(-15, 15, (2, 6, 2)),
                         jnp.float32),
      ped_yaw=jnp.asarray(rs.uniform(-3, 3, (2, 6)), jnp.float32))
  want = np.asarray(jax.vmap(
      lambda s: jsynth._bird_view_classes(jp, s))(states))  # pylint: disable=protected-access
  tp = tsim.make_params(torch_load_town("Town03"), device="cpu")
  ts = ttypes.scene_state_from_numpy(jax_state_to_numpy(states), "cpu")
  got = tsynth._bird_view_classes(tp, ts).numpy()  # pylint: disable=protected-access
  assert got.dtype == want.dtype
  assert np.mean(got != want) < BIRD_VIEW_PIXEL_FRACTION
  for code in (4, 5, 6):
    assert (want == code).sum() > 20, code
