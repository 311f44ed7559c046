"""The names that ``tests/test_torch_api_surface.py`` found missing from the
port, held against the JAX package on the CPU: the closed-loop
``sim.rollout(policy=)``, ``autopilot_policy(target_speed=)``,
``ops.transforms.wrap_angle``, ``init_scene(rng=)`` and the
``sim``/``ops``/``sensors`` exports."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oatomobile_torch import sim as tsim
from oatomobile_torch.maps import load_town as torch_load_town
from oatomobile_torch.ops import transforms as ttransforms
from oatomobile_torch.sim import autopilot as tautopilot
from oatomobile_torch.sim import types as ttypes
from oatomobile_tpu import sim as jsim
from oatomobile_tpu.maps import load_town as jax_load_town
from oatomobile_tpu.ops import transforms as jtransforms
from torch_port_helpers import (assert_states_match, flatten,
                                jax_state_to_numpy)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

B, T = 2, 8
# One step's tolerances (tests/test_torch_sim.py): floats to 1e-5, the
# lateral PID's arccos angle to 1e-3, the steer to 2.5e-3.  The T = 8
# closed-loop steps hold to the one step's: their largest float difference
# is 1.2e-7 (a pedestrian's yaw), so no allowance for drift is needed.
STEP_ATOL = 1e-5
ANGLE_ATOL = {"pid_lat.err_buf": 1e-3, "pid_lat.prev_error": 1e-3}
STEER_ATOL = 2.5e-3
TARGET_SPEED = 40.0 / 3.6
RAISED_LIMIT = 50.0 / 3.6


@pytest.fixture(scope="module")
def towns():
  jt, tt = jax_load_town("Town02"), torch_load_town("Town02")
  return jt, tt, jsim.make_params(jt), tsim.make_params(tt, device="cpu")


def _scenes(jt, tt, batch, seed):
  kwargs = dict(num_vehicles=4, num_pedestrians=2, seed=seed)
  return (jsim.init_scene_batch(jt, batch, **kwargs),
          tsim.init_scene_batch(tt, batch, device="cpu", **kwargs))


def _raise_limit(jp, tp):
  """Both params with every waypoint's speed limit at 50 km/h (Town02's
  are all 30 km/h, under which ``target_speed`` changes nothing)."""
  limit = np.full_like(np.asarray(jp.map["wp_speed_limit"]), RAISED_LIMIT)
  jp = jp.replace(map={**jp.map, "wp_speed_limit": jnp.asarray(limit)})
  tp = tp.replace(map={**tp.map, "wp_speed_limit": torch.from_numpy(limit)})
  return jp, tp


def _time_major(state) -> dict:
  """The port's per-step states [T, B, ...] as the JAX vmap's [B, T, ...]."""
  return {k: np.swapaxes(v, 0, 1)
          for k, v in flatten(ttypes.scene_state_to_numpy(state)).items()}


def test_closed_loop_rollout_matches(towns):
  jt, tt, jp, tp = towns
  jp, tp = _raise_limit(jp, tp)
  jstate, tstate = _scenes(jt, tt, B, seed=11)
  # With a policy the actions' values are ignored; only T counts.
  actions = np.random.RandomState(0).uniform(-1, 1, (T, B, 3)).astype(
      np.float32)

  def jpolicy(p, s):
    return jsim.autopilot_policy(p, s, target_speed=TARGET_SPEED)

  def tpolicy(p, s):
    return tsim.autopilot_policy(p, s, target_speed=TARGET_SPEED)

  want_final, want_traj = jax.jit(jax.vmap(
      lambda s, a: jsim.rollout(jp, s, a, policy=jpolicy),
      in_axes=(0, 1)))(jstate, jnp.asarray(actions))
  got_final, got_traj = tsim.rollout(tp, tstate, torch.from_numpy(actions),
                                     policy=tpolicy)
  assert_states_match(jax_state_to_numpy(want_final),
                      ttypes.scene_state_to_numpy(got_final),
                      atol=STEP_ATOL, atol_by_field=ANGLE_ATOL)
  want = flatten(jax_state_to_numpy(want_traj))
  got = _time_major(got_traj)
  assert set(got) == set(want)
  for name, value in want.items():
    assert got[name].shape == value.shape and got[name].dtype == value.dtype
    if value.dtype.kind == "f":
      np.testing.assert_allclose(got[name], value, rtol=0,
                                 atol=ANGLE_ATOL.get(name, STEP_ATOL),
                                 err_msg=name)
    else:
      np.testing.assert_array_equal(got[name], value, err_msg=name)
  # The heroes moved, and each step counted.
  np.testing.assert_array_equal(got["step"][:, -1], T)
  assert float(got_final.hero_speed.min()) > 0.5

  # The rollout is the policy, then the step, T times; other actions
  # change nothing.
  state = tstate
  for _ in range(T):
    action, state = tpolicy(tp, state)
    state = tsim.world_step(tp, state, action)
  zeros = tsim.rollout(tp, tstate, torch.zeros(T, B, 3), policy=tpolicy)[0]
  for other in (state, zeros):
    assert_states_match(ttypes.scene_state_to_numpy(other),
                        ttypes.scene_state_to_numpy(got_final), atol=0.0)


def test_open_loop_rollout_is_the_step_loop(towns):
  """Without a policy, ``rollout`` steps the given actions, bit for bit."""
  _, tt, _, tp = towns
  state = tsim.init_scene_batch(tt, B, num_vehicles=2, seed=3, device="cpu")
  actions = torch.from_numpy(np.random.RandomState(1).uniform(
      0, 1, (T, B, 3)).astype(np.float32))
  final, traj = tsim.rollout(tp, state, actions)
  for t in range(T):
    state = tsim.world_step(tp, state, actions[t])
    assert_states_match(ttypes.scene_state_to_numpy(state),
                        ttypes.scene_state_to_numpy(
                            ttypes.map_state(lambda x, t=t: x[t], traj)),
                        atol=0.0)
  assert_states_match(ttypes.scene_state_to_numpy(state),
                      ttypes.scene_state_to_numpy(final), atol=0.0)


def test_rollout_without_actions_raises_on_both_sides(towns):
  jt, tt, jp, tp = towns
  jstate = jsim.init_scene(jt, num_vehicles=1, jax_seed=2)
  tstate = tsim.init_scene(tt, num_vehicles=1, jax_seed=2, device="cpu")

  def jpolicy(p, s):
    return jsim.autopilot_policy(p, s)

  with pytest.raises(ValueError):
    jsim.rollout(jp, jstate, None, policy=jpolicy)
  with pytest.raises(ValueError):
    tsim.rollout(tp, tstate, None, policy=tsim.autopilot_policy)
  with pytest.raises(ValueError):
    tsim.rollout(tp, tstate, None)


def _driven(jt, tt, jp, batch, seed, steps):
  """JAX scenes driven ``steps`` by the default autopilot, and the port's
  copy of them."""
  jstate, _ = _scenes(jt, tt, batch, seed)
  policy = jax.vmap(lambda s: jsim.autopilot_policy(jp, s))
  step = jax.vmap(jsim.world_step, in_axes=(None, 0, 0))

  @jax.jit
  def drive(state):
    def body(s, _):
      action, s = policy(s)
      return step(jp, s, action), None
    return jax.lax.scan(body, state, None, length=steps)[0]

  jstate = drive(jstate)
  return jstate, ttypes.scene_state_from_numpy(jax_state_to_numpy(jstate),
                                               "cpu")


def test_target_speed_matches(towns):
  jt, tt, jp, tp = towns
  jp, tp = _raise_limit(jp, tp)
  jstate, tstate = _driven(jt, tt, jp, 4, seed=5, steps=160)
  want_action, want = jax.jit(jax.vmap(lambda s: jsim.autopilot_policy(
      jp, s, target_speed=TARGET_SPEED)))(jstate)
  got_action, got = tsim.autopilot_policy(tp, tstate,
                                          target_speed=TARGET_SPEED)
  want_action = np.asarray(want_action)
  np.testing.assert_allclose(got_action.numpy()[:, [0, 2]],
                             want_action[:, [0, 2]], rtol=0, atol=STEP_ATOL)
  np.testing.assert_allclose(got_action.numpy()[:, 1], want_action[:, 1],
                             rtol=0, atol=STEER_ATOL)
  assert_states_match(jax_state_to_numpy(want),
                      ttypes.scene_state_to_numpy(got), atol=STEP_ATOL,
                      atol_by_field=ANGLE_ATOL)
  # The knob is live under the raised limit: some scene's throttle or
  # brake moves with it.
  default_action, _ = tsim.autopilot_policy(tp, tstate)
  assert bool((default_action != got_action).any(dim=-1).any())


def test_target_speed_at_or_under_30_kmh_changes_nothing(towns):
  """The cruise base is max(target_speed, 30 km/h): the default (20 km/h)
  and 25 km/h give the actions and states that no argument gives."""
  jt, tt, jp, tp = towns
  jp, tp = _raise_limit(jp, tp)
  _, tstate = _driven(jt, tt, jp, 4, seed=5, steps=160)
  base_action, base = tsim.autopilot_policy(tp, tstate)
  for speed in (tautopilot.TARGET_SPEED_MPS, 25.0 / 3.6):
    action, state = tsim.autopilot_policy(tp, tstate, target_speed=speed)
    assert torch.equal(action, base_action)
    assert_states_match(ttypes.scene_state_to_numpy(base),
                        ttypes.scene_state_to_numpy(state), atol=0.0)


@pytest.mark.parametrize("library", ["numpy", "torch"])
def test_wrap_angle_matches(library):
  theta = np.concatenate([
      np.random.RandomState(4).uniform(-20.0, 20.0, 256),
      [0.0, 1.0, -1.0, 3.0, -3.0, 7.0, -7.0, 10.0]]).astype(np.float32)
  want = np.asarray(jtransforms.wrap_angle(jnp.asarray(theta)))
  if library == "torch":
    got = ttransforms.wrap_angle(torch.from_numpy(theta))
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    got = got.numpy()
  else:
    got = ttransforms.wrap_angle(theta)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
  np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
  assert np.all(np.abs(got) <= np.pi)


def test_init_scene_with_rng_matches(towns):
  jt, tt, _, _ = towns
  kwargs = dict(num_vehicles=3, num_pedestrians=2, jax_seed=9)
  want = jsim.init_scene(jt, rng=np.random.RandomState(31), **kwargs)
  got = tsim.init_scene(tt, rng=np.random.RandomState(31), device="cpu",
                        **kwargs)
  want = {k: v[None] for k, v in flatten(jax_state_to_numpy(want)).items()}
  got = flatten(ttypes.scene_state_to_numpy(got))
  assert set(got) == set(want)
  for name, value in want.items():
    np.testing.assert_array_equal(got[name], value, err_msg=name)
  # Without one, the draws come from RandomState(jax_seed).
  seeded = tsim.init_scene(tt, rng=np.random.RandomState(9), device="cpu",
                           **kwargs)
  assert_states_match(
      ttypes.scene_state_to_numpy(tsim.init_scene(tt, device="cpu",
                                                  **kwargs)),
      ttypes.scene_state_to_numpy(seeded), atol=0.0)


def test_new_exports_are_the_module_functions():
  import oatomobile_torch.ops as tops
  import oatomobile_torch.sensors as tsensors
  from oatomobile_torch.ops import bev, bev_cuda, transforms
  from oatomobile_torch.sensors import cameras, synth
  from oatomobile_torch.sim import world
  assert tsim.batched_world_step is world.batched_world_step
  assert tsim.stack_scenes is world.stack_scenes
  assert {"batched_world_step", "stack_scenes"} <= set(tsim.__all__)
  assert (tops.bev, tops.bev_cuda, tops.transforms) == (bev, bev_cuda,
                                                        transforms)
  assert set(tops.__all__) == {"bev", "bev_cuda", "transforms"}
  assert transforms.wrap_angle is ttransforms.wrap_angle
  assert (tsensors.cameras, tsensors.synth) == (cameras, synth)
  assert set(tsensors.__all__) == {"cameras", "synth"}


@pytest.mark.parametrize("package", ["oatomobile_torch.sim",
                                     "oatomobile_torch.sensors",
                                     "oatomobile_torch.ops"])
def test_package_imports_alone_and_builds_nothing(package):
  """Each package imports first in a fresh process (no import cycle bites),
  without jax, and without building or loading the splat kernel."""
  code = ("import sys\n"
          "import {0}\n"
          "from oatomobile_torch.ops import bev_cuda\n"
          "assert bev_cuda._library.cache_info().currsize == 0\n"
          "assert 'jax' not in sys.modules\n"
          "assert set({0}.__all__) <= set(dir({0}))\n").format(package)
  env = dict(os.environ, PYTHONPATH=ROOT)
  subprocess.run([sys.executable, "-c", code], check=True, env=env,
                 cwd=ROOT, timeout=120)


def test_exported_stack_and_batched_step_match(towns):
  jt, tt, jp, tp = towns
  jstate, tstate = _scenes(jt, tt, B, seed=13)
  actions = np.random.RandomState(6).uniform(0, 1, (B, 3)).astype(np.float32)
  want = jsim.batched_world_step(jp, jstate, jnp.asarray(actions))
  got = tsim.batched_world_step(tp, tstate, torch.from_numpy(actions))
  assert_states_match(jax_state_to_numpy(want),
                      ttypes.scene_state_to_numpy(got), atol=STEP_ATOL)
  # stack_scenes of the one-scene batches is the batch.
  ones = [ttypes.map_state(lambda x, b=b: x[b:b + 1], tstate)
          for b in range(B)]
  assert_states_match(ttypes.scene_state_to_numpy(tsim.stack_scenes(ones)),
                      ttypes.scene_state_to_numpy(tstate), atol=0.0)
