"""The single-scene simulator's captured step and warm-up on the CPU.

``CUDASimulator`` keeps its scene in static buffers and runs its step
(``world_step`` and ``synthesize`` of every device sensor, the cameras and
the game state included) and its zero-action warm-up step through
``graphs.CapturedStep``.  Here, on the CPU and under ``FakeCapturedStep``
(the card's capture and replay played on the CPU, ``tests/
test_torch_compiled.py``), its observations over two episodes equal, bit
for bit, those of the plain eager loop it replaced (``init_scene``, the
warm-up's world steps, then a world step and a ``synthesize`` a step),
and they match the JAX package's ``TPUSimulator`` within the tolerances of
``tests/test_torch_env.py``; so do the ``AutopilotAgent``'s actions, which
it evaluates as the simulator's captured step of the agent
(``CUDASimulator.captured_step``).
"""

import numpy as np
import pytest
import torch

from oatomobile_torch.baselines.rulebased import AutopilotAgent
from oatomobile_torch.envs import CARLANavEnv
from oatomobile_torch.ops import bev_cuda
from oatomobile_torch.sensors import synth
from oatomobile_torch.sim import init_scene, world_step
from oatomobile_torch.simulators.cuda import defaults
from oatomobile_tpu.baselines.rulebased import \
    AutopilotAgent as JaxAutopilotAgent
from oatomobile_tpu.envs import CARLANavEnv as JaxCARLANavEnv
from test_torch_compiled import FakeCapturedStep, fake_card  # pylint: disable=unused-import
from test_torch_env import (ACTIONS, NAV_KWARGS, SEED, _assert_actions_close,
                            _compare_observations)

torch.set_num_threads(1)

SENSORS = tuple(defaults.CARLA_SENSORS) + ("front_camera_rgb", "game_state")
EPISODES = 2


def _drive(env):
  """[(observations, reward, done)] of EPISODES episodes of reset and the
  fixed actions."""
  env.seed(SEED)
  trace = []
  for _ in range(EPISODES):
    trace.append((env.reset(), 0.0, False))
    for action in ACTIONS:
      obs, reward, done, _ = env.step(action)
      trace.append((obs, reward, done))
  return trace


def _eager(sim):
  """The device observations of ``_drive`` by the plain eager loop, on the
  simulator's town, parameters and seed."""
  keys = sim._device_keys  # pylint: disable=protected-access
  zero = torch.zeros((1, 3))
  out = []
  for episode in range(1, EPISODES + 1):
    state = init_scene(sim.town, spawn_point=NAV_KWARGS["origin"],
                       destination=NAV_KWARGS["destination"],
                       num_vehicles=NAV_KWARGS["num_vehicles"],
                       route_capacity=defaults.DEFAULT_ROUTE_CAPACITY,
                       jax_seed=SEED + episode, device="cpu")
    for _ in range(NAV_KWARGS["warmup_steps"]):
      state = world_step(sim.params, state, zero)
    out.append(synth.synthesize(sim.params, state, keys))
    for action in ACTIONS:
      a = torch.tensor([[action["throttle"], action["steer"],
                         action["brake"]]])
      state = world_step(sim.params, state, a)
      out.append(synth.synthesize(sim.params, state, keys))
  return [{k: v[0].numpy() for k, v in obs.items()} for obs in out]


@pytest.fixture(params=[False, True], ids=["cpu", "fake_card"])
def card(request):
  if request.param:
    return request.getfixturevalue("fake_card")
  return None


def test_captured_step_equals_the_eager_loop(card):
  env = CARLANavEnv(**NAV_KWARGS, sensors=SENSORS, device="cpu")
  bev_cuda.KERNEL.launches = 0
  got = _drive(env)
  launches = bev_cuda.KERNEL.launches
  want = _eager(env.simulator)
  assert len(got) == len(want)
  for (obs, _, _), eager in zip(got, want):
    for key, value in eager.items():
      assert obs[key].dtype == value.dtype, key
      np.testing.assert_array_equal(obs[key], value, err_msg=key)
  assert {"front_camera_rgb", "game_state", "lidar"} <= set(want[0])
  if card is not None:
    # A step graph and a warm-up graph, each captured once; one splat at
    # each reset (eager) and one a step (replayed).
    assert len(card) == 2 and all(step.captured for step in card)
    assert launches == EPISODES * (len(ACTIONS) + 1)


def test_observations_match_the_jax_simulator(card):
  del card
  want = _drive(JaxCARLANavEnv(**NAV_KWARGS))
  got = _drive(CARLANavEnv(**NAV_KWARGS, device="cpu"))
  for (wo, wr, wd), (go, gr, gd) in zip(want, got):
    _compare_observations(wo, go)
    assert (gr, gd) == (wr, wd)


def test_reset_and_state_use_the_static_buffers(card):
  """``reset`` copies the new scene into the buffers the graphs read (the
  warm-up ran ``warmup_steps`` steps), ``state`` is a copy, and an agent's
  write-back lands in the buffers."""
  del card
  env = CARLANavEnv(**NAV_KWARGS, device="cpu")
  env.seed(SEED)
  sim = env.simulator
  env.reset()
  live = sim._state  # pylint: disable=protected-access
  assert int(sim.state.step[0]) == NAV_KWARGS["warmup_steps"]
  copy = sim.state
  copy.hero_xy.add_(100.0)
  assert not torch.equal(copy.hero_xy, sim.state.hero_xy)
  agent = AutopilotAgent(env, noise=0.0)
  for _ in range(3):
    env.step(agent.act(None))
  assert int(sim.state.step[0]) == NAV_KWARGS["warmup_steps"] + 3
  assert float(sim.state.pid_lon.err_buf.abs().sum()) > 0.0
  env.reset()
  assert sim._state is live  # pylint: disable=protected-access
  assert int(sim.state.step[0]) == NAV_KWARGS["warmup_steps"]


def test_autopilot_agent_captured_matches_jax(card):
  """Ten steps of the AutopilotAgent (noise 0.1: its threefry draws run
  in the captured step too) against the JAX agent's actions."""
  jenv = JaxCARLANavEnv(**NAV_KWARGS)
  tenv = CARLANavEnv(**NAV_KWARGS, device="cpu")
  jenv.seed(SEED)
  tenv.seed(SEED)
  jobs, tobs = jenv.reset(), tenv.reset()
  jagent, tagent = JaxAutopilotAgent(jenv), AutopilotAgent(tenv)
  for _ in range(10):
    ja, ta = jagent.act(jobs), tagent.act(tobs)
    _assert_actions_close(ta, ja)
    jobs, _, _, _ = jenv.step(ja)
    tobs, _, _, _ = tenv.step(ta)
  _compare_observations(jobs, tobs)
  if card is not None:
    # The step, the warm-up and the agent's policy, each captured once.
    assert len(card) == 3 and all(step.captured for step in card)
