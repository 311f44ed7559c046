"""oatomobile_torch.sensors.synth against oatomobile_tpu.sensors.synth on
the CPU: the state sensors, the goal sensor and the actor tracker from the
same scene state, and the sensors the port does not synthesise yet."""

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


@pytest.mark.parametrize("key", tsynth.NOT_PORTED)
def test_sensors_not_ported_raise(scenes, key):
  _, _, tp, ts = scenes
  with pytest.raises(NotImplementedError):
    tsynth.synthesize(tp, ts, (key,))
