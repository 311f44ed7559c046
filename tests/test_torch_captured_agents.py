"""The single-scene learned agents' captured act (DIM, RIP with K = 2 under
WCM, MA and BCM, CIL) on the CPU.

Each agent drives a Town02 ``CARLANavEnv`` for a few steps twice from one
seed: eagerly (``CapturedStep`` on the CPU runs its function every call)
and under ``FakeCapturedStep`` (``tests/test_torch_compiled.py``), which
plays the card's warm-up, capture and replays, the replays writing into
the outputs of the capture.  Plans, actions and observations must be
equal.  The captured agent's plans and actions are held against the JAX
package's agent on the same observations (plans within 1e-4 m, actions
within ACTION_ATOL); weights are seeded numpy flax trees carried across
by ``models.convert``.  The traced scalars (``lr``, ``epsilon``) change the
plan without a new capture; a new ``num_steps`` builds a second step.
"""

import gc
import weakref

import numpy as np
import pytest
import torch

from oatomobile_torch import graphs
from oatomobile_torch import models as tmodels
from oatomobile_torch.baselines.learned import CILAgent, DIMAgent, RIPAgent
from oatomobile_torch.models import convert
from oatomobile_tpu import models as jmodels
from oatomobile_tpu.baselines.learned import CILAgent as JaxCILAgent
from oatomobile_tpu.baselines.learned import DIMAgent as JaxDIMAgent
from oatomobile_tpu.baselines.learned import RIPAgent as JaxRIPAgent
from test_torch_compiled import FakeCapturedStep, fake_card  # pylint: disable=unused-import
from test_torch_env import _assert_actions_close, _nav_envs
from test_torch_models import dim_context, random_tree
from test_torch_policies import _jax_dim

torch.set_num_threads(1)

STEPS = 3
# Plans of the port's and the JAX package's agents (40 interpolated
# ego-frame points) agree to ~1e-5 m (tests/test_torch_env.py).
PLAN_ATOL = 1e-4


def _dim_pair():
  jm, tree = _jax_dim(0)
  return ((lambda env: JaxDIMAgent(env, model=jm, params=tree)),
          (lambda env: DIMAgent(env, model=convert.load(
              tmodels.ImitativeModel(device="cpu"), tree))))


def _rip_pair(algorithm):
  members = [_jax_dim(seed) for seed in (0, 1)]
  trees = [tree for _, tree in members]
  return ((lambda env: JaxRIPAgent(env, algorithm=algorithm,
                                   model=members[0][0], params_list=trees)),
          (lambda env: RIPAgent(env, algorithm=algorithm,
                                models=convert.load_ensemble(
                                    [tmodels.ImitativeModel(device="cpu")
                                     for _ in trees], trees))))


def _cil_pair():
  import jax.numpy as jnp  # pylint: disable=import-outside-toplevel
  jm = jmodels.BehaviouralModel()
  ctx = dict(dim_context(1, 0), mode=np.zeros((1, 1), np.float32))
  tree = random_tree(jm, **{k: jnp.asarray(v) for k, v in ctx.items()})
  return ((lambda env: JaxCILAgent(env, model=jm, params=tree)),
          (lambda env: CILAgent(env, model=convert.load(
              tmodels.BehaviouralModel(device="cpu"), tree))))


AGENTS = {"dim": _dim_pair, "rip_wcm": lambda: _rip_pair("WCM"),
          "rip_ma": lambda: _rip_pair("MA"),
          "rip_bcm": lambda: _rip_pair("BCM"), "cil": _cil_pair}


@pytest.fixture(scope="module", params=sorted(AGENTS))
def pair(request):
  return request.param, AGENTS[request.param]()


def _drive(make_agent, jax_agent=None):
  """``STEPS`` steps of a port env driven by ``make_agent(env)``: the
  observations, plans and actions; each plan and action also held against
  ``jax_agent`` on the same observation."""
  jenv, tenv = _nav_envs(warmup_steps=0, num_vehicles=0)
  agent = make_agent(tenv)
  jagent = None if jax_agent is None else jax_agent(jenv)
  if jagent is not None:
    jenv.reset()
  obs = tenv.reset()
  trace = {"obs": [], "plan": [], "action": []}
  for _ in range(STEPS):
    plan = agent(dict(obs))
    action = agent.act(obs)
    if jagent is not None:
      want = np.asarray(jagent(dict(obs)))
      assert plan.shape == want.shape
      np.testing.assert_allclose(plan, want, rtol=0, atol=PLAN_ATOL)
      _assert_actions_close(action, jagent.act(obs))
    trace["obs"].append({k: np.array(v) for k, v in obs.items()})
    trace["plan"].append(plan)
    trace["action"].append(action.as_array())
    obs, _, _, _ = tenv.step(action)
  return agent, trace


def test_captured_agent_equals_eager_and_matches_jax(pair, request):
  name, (jax_agent, port_agent) = pair
  _, eager = _drive(port_agent)
  request.getfixturevalue("fake_card")
  agent, captured = _drive(port_agent, jax_agent)
  for key in ("plan", "action"):
    for step, (got, want) in enumerate(zip(captured[key], eager[key])):
      np.testing.assert_array_equal(got, want, err_msg="{} {} step {}".format(
          name, key, step))
  for got, want in zip(captured["obs"], eager["obs"]):
    for k in want:
      np.testing.assert_array_equal(got[k], want[k], err_msg=k)
  # One step, captured at the third of the 2 * STEPS calls and replayed.
  steps = list(_act(agent).steps.values())
  assert len(steps) == 1 and steps[0].captured
  assert steps[0] in FakeCapturedStep.instances
  assert np.abs(np.asarray(captured["action"])).sum() > 0


def _act(agent):
  """The agent's ``common.CapturedAct``."""
  return agent._forward if isinstance(agent, CILAgent) else agent._plan  # pylint: disable=protected-access


@pytest.mark.parametrize("name", ["dim", "rip_wcm"])
def test_traced_scalars_change_the_plan_without_a_capture(name, fake_card):  # pylint: disable=redefined-outer-name
  del fake_card
  jax_agent, port_agent = AGENTS[name]()
  jenv, tenv = _nav_envs(warmup_steps=0, num_vehicles=0)
  jenv.reset()
  obs = tenv.reset()
  agent, jagent = port_agent(tenv), jax_agent(jenv)
  plans = []
  for lr, epsilon in ((5e-2, 1.0), (5e-2, 1.0), (5e-2, 1.0), (2e-1, 1.0),
                      (2e-1, 0.3)):
    got = agent(dict(obs), lr=lr, epsilon=epsilon)
    want = np.asarray(jagent(dict(obs), lr=lr, epsilon=epsilon))
    np.testing.assert_allclose(got, want, rtol=0, atol=PLAN_ATOL)
    plans.append(got)
  steps = list(_act(agent).steps.values())
  assert len(steps) == 1 and steps[0].captured
  np.testing.assert_array_equal(plans[1], plans[0])
  assert np.abs(plans[3] - plans[2]).max() > 1e-3  # lr moved the plan
  assert np.abs(plans[4] - plans[3]).max() > 1e-3  # and so did epsilon
  # A new num_steps is a new static argument: a second step.
  got = agent(dict(obs), num_steps=3)
  want = np.asarray(jagent(dict(obs), num_steps=3))
  np.testing.assert_allclose(got, want, rtol=0, atol=PLAN_ATOL)
  assert len(_act(agent).steps) == 2
  assert np.abs(got - plans[0]).max() > 1e-4


def test_another_goal_shape_raises():
  _, port_agent = AGENTS["dim"]()
  _, tenv = _nav_envs(warmup_steps=0, num_vehicles=0)
  obs = tenv.reset()
  agent = port_agent(tenv)
  agent(dict(obs), num_steps=2)
  bad = dict(obs, goal=np.concatenate([obs["goal"], obs["goal"][:1]]))
  with pytest.raises(ValueError, match="goal"):
    agent(bad, num_steps=2)
  assert len(_act(agent).steps) == 1


def test_agent_steps_die_with_the_agent():
  """No reference cycle keeps an agent's steps (and, on a card, their
  graphs) alive: they go with the agent, without the collector."""
  _, port_agent = AGENTS["dim"]()
  _, tenv = _nav_envs(warmup_steps=0, num_vehicles=0)
  obs = tenv.reset()
  agent = port_agent(tenv)
  agent(dict(obs), num_steps=2)
  step = weakref.ref(next(iter(_act(agent).steps.values())))
  collecting = gc.isenabled()
  gc.disable()
  try:
    del agent
    assert step() is None
  finally:
    if collecting:
      gc.enable()


def test_captured_step_is_the_graphs_runner():
  """The agents build their steps through ``graphs.CapturedStep`` (looked
  up at each build, so a test or a yardstick may swap it)."""
  _, port_agent = AGENTS["cil"]()
  _, tenv = _nav_envs(warmup_steps=0, num_vehicles=0)
  obs = tenv.reset()
  agent = port_agent(tenv)
  agent(dict(obs))
  (step,) = _act(agent).steps.values()
  assert type(step) is graphs.CapturedStep  # pylint: disable=unidiomatic-typecheck
