"""oatomobile_torch.sim against oatomobile_tpu.sim on the CPU: scene
initialisation, one world step, one autopilot step and the golden
replay."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oatomobile_torch import sim as tsim
from oatomobile_torch.maps import load_town as torch_load_town
from oatomobile_torch.sim import types as ttypes
from oatomobile_tpu import sim as jsim
from oatomobile_tpu.maps import load_town as jax_load_town
from torch_port_helpers import (assert_states_match, jax_params_to_numpy,
                                jax_state_to_numpy)

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "golden_replay_town02.npz")

# Float tolerance of one step: the two libraries round the same float32
# expressions differently (XLA on the CPU contracts x*y+z into an FMA,
# torch rounds the product and the sum) and their sin/cos/atan2 differ in
# the last ulp.  Each such difference is ~1e-7 relative; 1e-5 bounds it on
# positions and speeds of ~100 m and ~10 m/s.
STEP_ATOL = 1e-5
# The lateral controller's angle is arccos(cos_a): near cos_a = 1 the
# derivative 1/sqrt(1 - x^2) turns a 1-ulp difference of cos_a (6e-8)
# into up to sqrt(2 * 1.2e-7) = 5e-4 of angle.  The PID state holds that
# angle, and the steer is 1.95 * angle + 0.01 * 20 * angle + 1.4 * window
# sum * dt, so it moves by up to ~2.2x as much.
ANGLE_ATOL = {"pid_lat.err_buf": 1e-3, "pid_lat.prev_error": 1e-3}
STEER_ATOL = 2.5e-3


def test_init_scene_batch_matches():
  jt, tt = jax_load_town("Town02"), torch_load_town("Town02")
  want = jsim.init_scene_batch(jt, 4, num_vehicles=8, num_pedestrians=4,
                               seed=5)
  got = tsim.init_scene_batch(tt, 4, num_vehicles=8, num_pedestrians=4,
                              seed=5, device="cpu")
  # Host-side numpy draws and threefry keys: everything is exact.
  assert_states_match(jax_state_to_numpy(want),
                      ttypes.scene_state_to_numpy(got), atol=0.0)


def test_make_params_matches():
  jt, tt = jax_load_town("Town03"), torch_load_town("Town03")
  want = ttypes.world_params_from_numpy(
      jax_params_to_numpy(jsim.make_params(jt)), "cpu")
  got = tsim.make_params(tt, device="cpu")
  for name in ("dt", "npc_target_speed", "tl_green", "tl_yellow",
               "proximity_vehicle_threshold", "proximity_tlight_threshold"):
    assert torch.equal(getattr(got, name), getattr(want, name)), name
  for name in ("length", "width", "wheelbase", "max_steer_rad", "max_accel",
               "max_brake", "drag", "roll"):
    assert torch.equal(getattr(got.vehicle, name),
                       getattr(want.vehicle, name)), name
  assert (got.wall_budget, got.road_budget) == (want.wall_budget,
                                                 want.road_budget)
  for key, value in want.map.items():
    assert torch.equal(got.map[key], value), key


@pytest.mark.parametrize("town,num_vehicles,num_pedestrians",
                         [("Town02", 8, 4), ("Town03", 12, 3)])
def test_one_step_matches(town, num_vehicles, num_pedestrians):
  jt, tt = jax_load_town(town), torch_load_town(town)
  jp = jsim.make_params(jt)
  tp = tsim.make_params(tt, device="cpu")
  state = jsim.init_scene_batch(jt, 4, num_vehicles=num_vehicles,
                                num_pedestrians=num_pedestrians, seed=5)
  policy = jax.jit(jax.vmap(lambda s: jsim.autopilot_policy(jp, s)))
  step = jax.jit(jax.vmap(jsim.world_step, in_axes=(None, 0, 0)))
  # Drive the JAX scenes off their spawns so the step sees traffic,
  # moving heroes and filled PID windows.
  for _ in range(30):
    action, state = policy(state)
    state = step(jp, state, action)

  tstate = ttypes.scene_state_from_numpy(jax_state_to_numpy(state), "cpu")
  want_action, want = policy(state)
  got_action, got = tsim.autopilot_policy(tp, tstate)
  want_action = np.asarray(want_action)
  np.testing.assert_allclose(got_action.numpy()[:, [0, 2]],
                             want_action[:, [0, 2]], rtol=0, atol=STEP_ATOL)
  np.testing.assert_allclose(got_action.numpy()[:, 1], want_action[:, 1],
                             rtol=0, atol=STEER_ATOL)
  assert_states_match(jax_state_to_numpy(want),
                      ttypes.scene_state_to_numpy(got), atol=STEP_ATOL,
                      atol_by_field=ANGLE_ATOL)

  # One world step from the same (JAX) state and actions.
  want = step(jp, want, jnp.asarray(want_action))
  got = tsim.world_step(
      tp, ttypes.scene_state_from_numpy(
          jax_state_to_numpy(policy(state)[1]), "cpu"),
      torch.tensor(want_action))
  assert_states_match(jax_state_to_numpy(want),
                      ttypes.scene_state_to_numpy(got), atol=STEP_ATOL)


def test_autopilot_noise_matches():
  # Epsilon-noise: which scenes take a random action, and that action, come
  # from threefry uniforms on ranges of width 1 and 2, bit-exact.
  jt, tt = jax_load_town("Town02"), torch_load_town("Town02")
  jp = jsim.make_params(jt)
  tp = tsim.make_params(tt, device="cpu")
  state = jsim.init_scene_batch(jt, 8, num_vehicles=4, seed=8)
  want_action, want = jax.vmap(
      lambda s: jsim.autopilot_policy(jp, s, noise=0.5))(state)
  want_action = np.asarray(want_action)
  tstate = ttypes.scene_state_from_numpy(jax_state_to_numpy(state), "cpu")
  got_action, got = tsim.autopilot_policy(tp, tstate, noise=0.5)
  got_action = got_action.numpy()
  expert_action = tsim.autopilot_policy(tp, tstate)[0].numpy()
  noisy = np.any(got_action != expert_action, axis=-1)
  assert 0 < noisy.sum() < 8
  np.testing.assert_array_equal(got_action[noisy], want_action[noisy])
  # The expert's own actions, at the one-step tolerances above.
  np.testing.assert_allclose(got_action[~noisy], want_action[~noisy],
                             rtol=0, atol=STEER_ATOL)
  np.testing.assert_array_equal(ttypes.scene_state_to_numpy(got)["rng"],
                                np.asarray(want.rng))


def test_golden_replay_matches():
  # The JAX package's golden replay (tests/test_replay.py), driven through
  # the port's init_scene and rollout, at the same tolerances.
  golden = np.load(GOLDEN)
  town = torch_load_town("Town02")
  params = tsim.make_params(town, device="cpu")
  state = tsim.init_scene(town, spawn_point=3, destination=40,
                          num_vehicles=4, jax_seed=123, device="cpu")
  actions = torch.as_tensor(golden["actions"])[:, None, :]
  final, traj = tsim.rollout(params, state, actions)

  np.testing.assert_allclose(traj.hero_xy[:, 0].numpy(), golden["hero_xy"],
                             atol=1e-3)
  np.testing.assert_allclose(traj.hero_yaw[:, 0].numpy(),
                             golden["hero_yaw"], atol=1e-4)
  np.testing.assert_allclose(traj.hero_speed[:, 0].numpy(),
                             golden["hero_speed"], atol=1e-3)
  np.testing.assert_array_equal(traj.collision[:, 0].numpy() > 0,
                                golden["collision"] > 0)
  np.testing.assert_array_equal(traj.lane_invasion[:, 0].numpy(),
                                golden["lane_invasion"])
  np.testing.assert_allclose(final.npc_xy[0].numpy(), golden["npc_xy_final"],
                             atol=1e-3)
