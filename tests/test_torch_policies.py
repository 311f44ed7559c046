"""The port's learned in-loop policies against the JAX package's on the
CPU: the plan -> control bridge under each of its flags, one call each of
the DIM, RIP and CIL policies on the same scenes, and a short DIM
rollout.  Weights are the seeded numpy trees of ``test_torch_models``,
carried across by ``oatomobile_torch.models.convert``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oatomobile_torch import models as tmodels
from oatomobile_torch.baselines.learned import bridge as tbridge
from oatomobile_torch.baselines.learned.cil.policy import (make_cil_policy,
                                                            mode_from_goal)
from oatomobile_torch.baselines.learned.dim.policy import make_dim_policy
from oatomobile_torch.baselines.learned.rip.agent import stack_ensemble
from oatomobile_torch.baselines.learned.rip.policy import make_rip_policy
from oatomobile_torch.envs.batched import BatchedEnv as TorchBatchedEnv
from oatomobile_torch.models import convert
from oatomobile_torch.sim import dynamics as tdynamics
from oatomobile_torch.sim.types import PIDState as TorchPIDState
from oatomobile_torch.sim.types import (scene_state_from_numpy,
                                        scene_state_to_numpy,
                                        world_params_from_numpy)
from oatomobile_tpu import models as jmodels
from oatomobile_tpu.baselines.learned import bridge as jbridge
from oatomobile_tpu.baselines.learned.cil import policy as jcil
from oatomobile_tpu.baselines.learned.dim.policy import \
    make_dim_policy as jmake_dim_policy
from oatomobile_tpu.baselines.learned.rip.agent import \
    stack_ensemble as jstack_ensemble
from oatomobile_tpu.baselines.learned.rip.policy import \
    make_rip_policy as jmake_rip_policy
from oatomobile_tpu.envs.batched import BatchedEnv as JaxBatchedEnv
from oatomobile_tpu.sim import dynamics as jdynamics
from oatomobile_tpu.sim.types import PIDState as JaxPIDState
from test_torch_models import dim_context, random_tree
from torch_port_helpers import (assert_states_match, jax_params_to_numpy,
                                jax_state_to_numpy)

torch.set_num_threads(1)

# One control step, as tests/test_torch_sim.py: floats to 1e-5 (XLA on the
# CPU contracts x*y+z into an FMA; torch rounds twice), the lateral PID's
# arccos angle to 1e-3 near cos = 1, the steer to 2.5e-3.
STEP_ATOL = 1e-5
ANGLE_ATOL = {"pid_lat.err_buf": 1e-3, "pid_lat.prev_error": 1e-3}
# The longitudinal PID works in km/h (error * 3.6, summed over a 30-step
# window): 1e-4 of km/h.
LON_ATOL = {"pid_lon.err_buf": 1e-4, "pid_lon.prev_error": 1e-4}
STEER_ATOL = 2.5e-3
# A policy's plan comes from 20 Adam steps whose first is lr * sign(g);
# with gradients clear of 0 (checked for the planner in
# test_torch_models.py) plans agree to 1e-5 m, and the bridge's arccos
# angle bounds the actions: 2.5e-3 on steer, 1e-4 on throttle and brake.
ACTION_ATOL = np.asarray([1e-4, STEER_ATOL, 1e-4])


@pytest.fixture(scope="module")
def scenes():
  """Town02 scenes driven off their spawns by the autopilot: the JAX
  env's params and state, and the port's copies of both."""
  env = JaxBatchedEnv("Town02", 3, num_vehicles=6, seed=2)
  env.rollout(15)
  jparams, jstate = env.params, env.state
  tparams = world_params_from_numpy(jax_params_to_numpy(jparams), "cpu")
  tstate = scene_state_from_numpy(jax_state_to_numpy(jstate), "cpu")
  return jparams, jstate, tparams, tstate


def _jax_dim(seed=0):
  jm = jmodels.ImitativeModel((4, 2), (100, 100))
  ctx = {k: jnp.zeros((1,) + v.shape[1:])
         for k, v in dim_context(1, 0).items()}
  return jm, random_tree(jm, jnp.zeros((1, 4, 2)), method=jm.log_prob,
                         seed=seed, **ctx)


@pytest.fixture(scope="module")
def dim_pair():
  jm, tree = _jax_dim()
  return jm, tree, convert.load(tmodels.ImitativeModel(device="cpu"), tree)


def _compare_step(jout, tout, extra_atol=None):
  (ja, js), (ta, ts) = jout, tout
  ja, ta = np.asarray(ja), ta.numpy()
  assert ta.shape == ja.shape and ta.dtype == ja.dtype
  for col in range(3):
    np.testing.assert_allclose(ta[:, col], ja[:, col], rtol=0,
                               atol=ACTION_ATOL[col], err_msg=str(col))
  assert_states_match(jax_state_to_numpy(js), scene_state_to_numpy(ts),
                      atol=STEP_ATOL,
                      atol_by_field={**ANGLE_ATOL, **LON_ATOL,
                                     **(extra_atol or {})})


# -- the bridge --------------------------------------------------------------------


def _bev(batch, seed):
  """Sparse above-ground returns, some in the forward corridor."""
  rs = np.random.RandomState(seed)
  lidar = np.zeros((batch, 200, 200, 2), np.float32)
  for b in range(batch):
    for _ in range(6):
      r, c = rs.randint(100, 120), rs.randint(88, 112)
      lidar[b, r:r + 3, c:c + 3, 1] = rs.uniform(0.1, 1.0)
  return lidar


def test_linspace_matches_jnp():
  for start, stop, num in ((2.5, 8.0, 16), (2.5, 4.0, 8)):
    want = np.asarray(jnp.linspace(start, stop, num))
    got = np.asarray(tbridge._linspace(start, stop, num), np.float32)  # pylint: disable=protected-access
    # XLA rounds start * (1 - t) + stop * t its own way: one ulp.
    np.testing.assert_allclose(got, want, rtol=2.4e-7, atol=0)


def test_bev_clear_probes_match():
  lidar = _bev(6, 1)
  rs = np.random.RandomState(2)
  toward = rs.uniform(-8, 8, size=(6, 2)).astype(np.float32)
  toward[:, 0] = np.abs(toward[:, 0]) + 1.0
  np.testing.assert_array_equal(
      tbridge.bev_clear_ahead(torch.from_numpy(lidar)).numpy(),
      np.asarray(jbridge.bev_clear_ahead(lidar)))
  for kwargs in ({}, {"reach_m": 4.0, "num_samples": 8}):
    want = np.asarray(jbridge.bev_clear_toward(lidar, toward, **kwargs))
    got = tbridge.bev_clear_toward(torch.from_numpy(lidar),
                                   torch.from_numpy(toward), **kwargs)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()


def test_longitudinal_control_matches():
  rs = np.random.RandomState(3)
  v = rs.uniform(0, 8, 5).astype(np.float32)
  target = rs.uniform(0, 8, 5).astype(np.float32)
  tstate = TorchPIDState.zero_batch(5, "cpu")
  jstate = jax.tree.map(lambda x: jnp.tile(x, (5,) + (1,) * x.ndim),
                        JaxPIDState.zero())
  dt = np.float32(0.05)
  for _ in range(3):
    jt, jstate = jax.vmap(lambda p, a, b: jdynamics.longitudinal_control(
        p, a, b, dt))(jstate, v, target)
    tt, tstate = tdynamics.longitudinal_control(
        tstate, torch.from_numpy(v), torch.from_numpy(target),
        torch.tensor(dt))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(tstate.err_buf.numpy(),
                               np.asarray(jstate.err_buf), rtol=0, atol=1e-4)


def _plans(batch, seed):
  """Forward plans with some bend, the last one degenerate (< 2 m)."""
  rs = np.random.RandomState(seed)
  steps = np.stack([rs.uniform(1.0, 4.0, (batch, 4)),
                    rs.uniform(-0.8, 0.8, (batch, 4))], -1)
  plan = np.cumsum(steps, axis=1).astype(np.float32)
  plan[-1] = (plan[-1] * 0.1).astype(np.float32)
  return plan


def _goals(batch, seed):
  """Ego-frame route waypoints 2 m apart, the first scene's all within
  4 m (the farthest one is then the fallback)."""
  rs = np.random.RandomState(seed)
  heading = rs.uniform(-0.6, 0.6, batch)
  d = np.arange(1.0, 21.0, 2.0)
  goal = np.stack([d[None] * np.cos(heading[:, None]),
                   d[None] * np.sin(heading[:, None])], -1)
  goal[0] = goal[0] * 0.15
  return goal.astype(np.float32)


@pytest.mark.parametrize("use_brake", [True, False])
@pytest.mark.parametrize("with_goal", [True, False])
@pytest.mark.parametrize("hero_wait", [0, 40, 270])
def test_plan_to_action_matches(scenes, use_brake, with_goal, hero_wait):
  """hero_wait 40 lies in the kick window, 270 in it and wedged (armed for
  more than 240 steps), 0 outside it; step 200 is past the warm-up."""
  jparams, jstate, tparams, _ = scenes
  B = 3
  jstate = jstate.replace(
      hero_wait=jnp.full(B, hero_wait, jnp.int32),
      step=jnp.asarray([200, 200, 50], jnp.int32),
      hero_speed=jnp.asarray([0.3, 0.8, 4.0], jnp.float32))
  tstate = scene_state_from_numpy(jax_state_to_numpy(jstate), "cpu")
  plan, goal, bev = _plans(B, 4), _goals(B, 5), _bev(B, 6)
  red = np.asarray([False, True, False])
  kwargs = dict(use_brake=use_brake, red_held=red, bev=bev,
                goal=goal if with_goal else None)
  jout = jbridge.plan_to_action(jparams, jstate, plan, **kwargs)
  tkwargs = {k: (None if v is None else torch.from_numpy(v))
             for k, v in kwargs.items() if k != "use_brake"}
  tout = tbridge.plan_to_action(tparams, tstate, torch.from_numpy(plan),
                                use_brake=use_brake, **tkwargs)
  _compare_step(jout, tout)
  if not use_brake:
    assert not tout[0][:, 2].any()


def test_plan_to_action_without_bev_or_stall_recovery(scenes):
  jparams, jstate, tparams, tstate = scenes
  plan, goal = _plans(3, 7), _goals(3, 8)
  clear = np.asarray([True, False, True])
  for kwargs in (dict(clear_ahead=clear, goal=goal),
                 dict(stall_recovery=False, curvature_slowdown=False,
                      warmup_floor=0.0, speed_gain=1.3)):
    jout = jbridge.plan_to_action(jparams, jstate, plan, **kwargs)
    tkwargs = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
               for k, v in kwargs.items()}
    tout = tbridge.plan_to_action(tparams, tstate, torch.from_numpy(plan),
                                  **tkwargs)
    _compare_step(jout, tout)


# -- the policies -------------------------------------------------------------------


def test_dim_policy_matches(scenes, dim_pair):
  jparams, jstate, tparams, tstate = scenes
  jm, tree, tm = dim_pair
  jout = jax.jit(jmake_dim_policy(jm, tree, num_plan_steps=20))(jparams,
                                                                jstate)
  policy = make_dim_policy(tm, num_plan_steps=20)
  tout = policy(tparams, tstate)
  _compare_step(jout, tout)
  assert not any(p.requires_grad or p.grad is not None
                 for p in tm.parameters())


RIP_ALGORITHMS = ("WCM", "MA", "BCM")


@pytest.fixture(scope="module")
def rip_members(scenes):
  """K = 3 members, and the JAX policy's outputs under each aggregator
  (one compile: the three share their encoder passes)."""
  jparams, jstate, _, _ = scenes
  members = [_jax_dim(seed) for seed in (0, 1, 2)]
  jm = members[0][0]
  stacked = jstack_ensemble([tree for _, tree in members])
  policies = [jmake_rip_policy(jm, stacked, algorithm=a, num_plan_steps=6)
              for a in RIP_ALGORITHMS]
  outs = jax.jit(lambda p, s: [f(p, s) for f in policies])(jparams, jstate)
  return [tree for _, tree in members], dict(zip(RIP_ALGORITHMS, outs))


@pytest.mark.parametrize("algorithm", RIP_ALGORITHMS)
def test_rip_policy_matches(scenes, rip_members, algorithm):
  _, _, tparams, tstate = scenes
  trees, jouts = rip_members
  ensemble = stack_ensemble(convert.load_ensemble(
      [tmodels.ImitativeModel(device="cpu") for _ in trees], trees))
  tout = make_rip_policy(ensemble, algorithm=algorithm,
                         num_plan_steps=6)(tparams, tstate)
  _compare_step(jouts[algorithm], tout)


def test_cil_policy_matches(scenes):
  jparams, jstate, tparams, tstate = scenes
  jm = jmodels.BehaviouralModel()
  ctx = dict(dim_context(1, 0), mode=np.zeros((1, 1), np.float32))
  tree = random_tree(jm, **{k: jnp.asarray(v) for k, v in ctx.items()})
  tm = convert.load(tmodels.BehaviouralModel(device="cpu"), tree)
  jout = jax.jit(jcil.make_cil_policy(jm, tree))(jparams, jstate)
  tout = make_cil_policy(tm)(tparams, tstate)
  _compare_step(jout, tout)


def test_mode_from_goal_matches():
  # Endpoints: ahead, within 3 m, 45 degrees right (+y), 45 degrees left,
  # and just inside 15 degrees.
  ends = np.asarray([[10.0, 0.0], [1.0, 1.0], [5.0, 5.0], [5.0, -5.0],
                     [10.0, 2.6]], np.float32)
  goal = np.repeat(ends[:, None], 10, axis=1)
  want = np.asarray(jcil.mode_from_goal_jnp(goal))
  got = mode_from_goal(torch.from_numpy(goal)).numpy()
  np.testing.assert_array_equal(got, want)
  np.testing.assert_array_equal(want, [0.0, 1.0, 3.0, 2.0, 0.0])


def test_dim_rollout_matches(dim_pair):
  jm, tree, tm = dim_pair
  kwargs = dict(num_vehicles=4, seed=1)
  jenv = JaxBatchedEnv("Town02", 2, **kwargs)
  tenv = TorchBatchedEnv("Town02", 2, device="cpu", **kwargs)
  _, _, want = jenv.rollout(3, policy=jmake_dim_policy(jm, tree,
                                                       num_plan_steps=3))
  _, _, got = tenv.rollout(3, policy=make_dim_policy(tm, num_plan_steps=3))
  want = {k: np.asarray(v) for k, v in want.items()}
  got = {k: v.numpy() for k, v in got.items()}
  np.testing.assert_array_equal(got["episodes"], want["episodes"])
  np.testing.assert_array_equal(got["collisions"], want["collisions"])
  np.testing.assert_allclose(got["distance"], want["distance"], rtol=0,
                             atol=1e-3)
  assert (got["distance"] > 0).all()
  # The policy's lidar is not a `compute` key: no checksum on either side.
  assert not got["obs_checksum"].any() and not want["obs_checksum"].any()
