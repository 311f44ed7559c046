"""The port's single-scene API against the JAX package's on the CPU: the
core API (env, wrappers, loop, episodes, benchmark), ``CARLAEnv`` /
``CARLANavEnv`` over the port's ``"carla"`` simulator, and the
single-scene agents (autopilot, blind, DIM, RIP, CIL; learned weights are
seeded numpy trees carried across by ``oatomobile_torch.models.convert``).
"""

import os

import numpy as np
import pytest
import torch

import oatomobile_torch
import oatomobile_tpu
from oatomobile_torch import models as tmodels
from oatomobile_torch.baselines.learned import CILAgent, DIMAgent, RIPAgent
from oatomobile_torch.baselines.rulebased import AutopilotAgent, BlindAgent
from oatomobile_torch.benchmarks.corl2017.benchmark import \
    _TASKS as CORL_TASKS
from oatomobile_torch.core.agent import Agent
from oatomobile_torch.core.benchmark import Benchmark
from oatomobile_torch.core.dataset import Episode
from oatomobile_torch.core.loop import EnvironmentLoop
from oatomobile_torch.core.registry import registry
from oatomobile_torch.core.rl import (Env, FiniteHorizonWrapper,
                                      ReturnsMetric, SaveToDiskWrapper,
                                      StepsMetric)
from oatomobile_torch.core.simulator import Sensor, SensorSuite, Simulator
from oatomobile_torch.envs import (CARLAEnv, CARLANavEnv, CollisionsMetric,
                                   DistanceMetric, LaneInvasionsMetric,
                                   TerminateOnCollisionWrapper)
from oatomobile_torch.models import convert
from oatomobile_torch.simulators.cuda.simulator import (CARLAAction,
                                                        CUDASimulator)
from oatomobile_torch.utils import spaces
from oatomobile_tpu import models as jmodels
from oatomobile_tpu.baselines.learned import CILAgent as JaxCILAgent
from oatomobile_tpu.baselines.learned import DIMAgent as JaxDIMAgent
from oatomobile_tpu.baselines.learned import RIPAgent as JaxRIPAgent
from oatomobile_tpu.baselines.rulebased import \
    AutopilotAgent as JaxAutopilotAgent
from oatomobile_tpu.envs import CARLANavEnv as JaxCARLANavEnv
from test_torch_models import dim_context, random_tree
from test_torch_policies import ACTION_ATOL, _jax_dim
from torch_port_helpers import fraction_beyond

torch.set_num_threads(1)

# -- the core API --------------------------------------------------------------


class _CounterSensor(Sensor):

  def __init__(self):
    self._count = 0
    super().__init__()

  def _get_uuid(self, *args, **kwargs):
    return "counter"

  def _get_sensor_type(self, *args, **kwargs):
    return None

  @property
  def observation_space(self):
    return spaces.Box(low=-np.inf, high=np.inf, shape=(1,), dtype=np.float32)

  def get_observation(self, *args, **kwargs):
    self._count += 1
    return np.asarray([self._count], dtype=np.float32)


class _FakeSimulator(Simulator):

  def __init__(self, **kwargs):
    self._suite = SensorSuite([_CounterSensor()])

  @property
  def sensor_suite(self):
    return self._suite

  def action_space(self):
    return spaces.Box(low=-1.0, high=1.0, shape=(2,), dtype=np.float32)

  def seed(self, seed):
    pass

  def reset(self):
    return self._suite.get_observations()

  def step(self, action):
    return self._suite.get_observations()

  def render(self, mode="rgb_array", *args, **kwargs):
    return np.zeros((4, 4, 3), dtype=np.uint8)

  def close(self):
    pass


class _NullAgent(Agent):

  def act(self, observations):
    return np.zeros((2,), dtype=np.float32)


class _Throttle(Agent):

  def act(self, observations):
    return {"throttle": 0.6, "steer": 0.0, "brake": 0.0}


def test_public_api_names_are_the_jax_packages():
  assert oatomobile_torch.__all__ == oatomobile_tpu.__all__
  for name in oatomobile_torch.__all__:
    assert hasattr(oatomobile_torch, name), name


def test_environment_loop_with_metrics_and_horizon():
  env = FiniteHorizonWrapper(Env(sim_fn=_FakeSimulator), max_episode_steps=5)
  assert env.unwrapped is not env
  assert env.simulator is env.unwrapped.simulator
  assert isinstance(env.observation_space, spaces.Dict)
  results = EnvironmentLoop(_NullAgent, env,
                            metrics=[StepsMetric(), ReturnsMetric()]).run()
  assert results == {"steps": 5, "returns": 0.0}


def test_save_to_disk_wrapper_writes_episodes(tmp_path):
  env = SaveToDiskWrapper(
      FiniteHorizonWrapper(Env(sim_fn=_FakeSimulator), max_episode_steps=3),
      output_dir=str(tmp_path))
  EnvironmentLoop(_NullAgent, env).run()
  (token,) = os.listdir(str(tmp_path))
  episode = Episode(str(tmp_path), token)
  samples = episode.fetch()
  assert len(samples) == 4  # reset + 3 steps
  np.testing.assert_array_equal(
      [episode.read_sample(s, attr="counter")[0] for s in samples],
      [1.0, 2.0, 3.0, 4.0])


def test_benchmark_evaluate_writes_metrics_csv(tmp_path):

  class _Bench(Benchmark):

    @property
    def tasks(self):
      return {"fake-v0": lambda: Env(sim_fn=_FakeSimulator)}

    @property
    def metrics(self):
      return [StepsMetric(), ReturnsMetric()]

  _Bench().load("fake-v0")
  with pytest.raises(ValueError):
    _Bench().load("missing-v0")
  bench = _Bench()
  bench.load = lambda task_id: FiniteHorizonWrapper(  # horizon of 4 steps
      bench.tasks[task_id](), max_episode_steps=4)
  bench.evaluate(_NullAgent, log_dir=str(tmp_path))
  with open(os.path.join(str(tmp_path), "fake-v0", "metrics.csv")) as fp:
    assert fp.read() == "steps,returns\n4,0.0\n"


def test_registry_is_the_ports_own():
  assert registry.get_simulator("carla") is CUDASimulator
  assert oatomobile_tpu.registry.get_simulator("carla") is not CUDASimulator
  for name in ("lidar", "bird_view_camera_rgb", "goal", "predictions"):
    assert registry.get_sensor(name) is not None, name


# -- CARLAEnv (mirrors tests/test_env.py) ----------------------------------------


@pytest.fixture(scope="module")
def env():
  env = CARLAEnv(town="Town02", sensors=("goal", "velocity"), spawn_point=3,
                 destination=40, device="cpu")
  yield env
  env.close()


def test_mandatory_sensors_present(env):
  obs = env.reset()
  for key in ("collision", "lane_invasion", "location", "rotation",
              "control", "predictions", "goal", "velocity"):
    assert key in obs, key


def test_observation_space_matches_observations(env):
  obs = env.reset()
  space = env.observation_space
  for key in ("location", "rotation", "control", "goal", "velocity",
              "collision", "lane_invasion"):
    assert tuple(space[key].shape) == np.asarray(obs[key]).shape, key


def test_action_space_dict(env):
  sample = env.action_space.sample()
  assert set(sample.keys()) == {"throttle", "steer", "brake"}
  env.reset()
  _, reward, done, info = env.step(sample)
  assert reward == 0.0 and done is False and info == {}


def test_step_accepts_carla_action(env):
  env.reset()
  obs, _, _, _ = env.step(CARLAAction(throttle=0.5))
  assert obs["control"][0] == pytest.approx(0.5)


def test_vehicle_moves_forward_and_goals_lie_ahead(env):
  obs0 = env.reset()
  assert obs0["goal"].shape == (10, 3) and obs0["goal"][1:, 0].mean() > 0.0
  for _ in range(30):
    obs, _, _, _ = env.step({"throttle": 0.8})
  assert np.linalg.norm(obs["location"] - obs0["location"]) > 1.0
  assert np.linalg.norm(obs["velocity"]) > 1.0


def test_render(env):
  env.reset()
  frame = env.render(mode="rgb_array")
  assert frame.shape == (200, 200, 3) and frame.dtype == np.uint8
  assert frame.max() > 0
  # The dashboard: bird view, front camera and LIDAR over the HUD.
  frame = env.render(mode="human")
  assert frame.shape == (276, 720, 3) and frame.dtype == np.uint8
  assert frame[:240].max() > 0


def test_predictions_write_back(env):
  env.reset()
  plan = np.ones((4, 2), dtype=np.float32)
  env.simulator.sensor_suite.get("predictions").predictions = plan
  obs, _, _, _ = env.step({"throttle": 0.0})
  np.testing.assert_array_equal(obs["predictions"], plan)


def test_environment_loop_with_carla_metrics():
  env = CARLAEnv(town="Town02", spawn_point=3, destination=40,
                 sensors=("goal",), device="cpu")
  env = TerminateOnCollisionWrapper(
      FiniteHorizonWrapper(env, max_episode_steps=25))
  metrics = [StepsMetric(), ReturnsMetric(), CollisionsMetric(),
             LaneInvasionsMetric(), DistanceMetric()]
  results = EnvironmentLoop(_Throttle, env, metrics=metrics).run()
  assert results["steps"] == 25
  assert results["distance"] > 0.0
  assert results["collisions"] == 0


# -- CARLANavEnv against the JAX package -----------------------------------------

TASK = "Town02_Turn0-v0"
NAV_KWARGS = dict(CORL_TASKS[TASK], num_vehicles=2, warmup_steps=4)
SEED = 7
ACTIONS = [{"throttle": 0.7, "steer": 0.0, "brake": 0.0},
           {"throttle": 1.0, "steer": 0.3, "brake": 0.0},
           {"throttle": 0.5, "steer": -0.2, "brake": 0.0},
           {"throttle": 0.0, "steer": 0.0, "brake": 0.6},
           {"throttle": 0.8, "steer": 0.1, "brake": 0.0}]
# One step's floats agree to 1e-5 (tests/test_torch_sim.py); over the
# warm-up and 5 steps, 1e-4.
STATE_ATOL = 1e-4
# LIDAR: a rect-edge pixel may fall either side (tests/test_torch_bev.py);
# bird view: a pixel centre on a raster cell or box edge may fall either
# side (tests/test_torch_sensors.py).
LIDAR_PIXEL_FRACTION = 1e-4
BIRD_VIEW_PIXEL_FRACTION = 1e-3


def _nav_envs(**kwargs):
  jenv = JaxCARLANavEnv(**dict(NAV_KWARGS, **kwargs))
  tenv = CARLANavEnv(**dict(NAV_KWARGS, **kwargs), device="cpu")
  jenv.seed(SEED)
  tenv.seed(SEED)
  return jenv, tenv


def _compare_observations(want, got):
  assert set(got) == set(want)
  for key in ("location", "rotation", "velocity", "goal", "control"):
    assert got[key].shape == want[key].shape, key
    assert got[key].dtype == want[key].dtype, key
    np.testing.assert_allclose(got[key], want[key], rtol=0, atol=STATE_ATOL,
                               err_msg=key)
  for key in ("collision", "lane_invasion", "is_at_traffic_light",
              "traffic_light_state"):
    assert got[key].dtype == want[key].dtype, key
    np.testing.assert_array_equal(got[key], want[key], err_msg=key)
  assert got["lidar"].shape == want["lidar"].shape == (200, 200, 2)
  assert fraction_beyond(got["lidar"], want["lidar"], 1e-6) < \
      LIDAR_PIXEL_FRACTION
  for key in ("bird_view_camera_rgb", "bird_view_camera_cityscapes"):
    assert got[key].shape == want[key].shape == (200, 200, 3), key
    differing = np.any(got[key] != want[key], axis=-1).mean()
    assert differing < BIRD_VIEW_PIXEL_FRACTION, (key, differing)


@pytest.fixture(scope="module")
def nav_run():
  """Reset and five fixed actions on the JAX env and on the port's."""
  jenv, tenv = _nav_envs()
  runs = []
  for env in (jenv, tenv):
    trace = [(env.reset(), 0.0, False)]
    for action in ACTIONS:
      obs, reward, done, _ = env.step(action)
      trace.append((obs, reward, done))
    runs.append(trace)
  return runs


def test_nav_env_observations_match(nav_run):
  want, got = nav_run
  for (wo, wr, wd), (go, gr, gd) in zip(want, got):
    _compare_observations(wo, go)
    assert (gr, gd) == (wr, wd)
  moved = np.linalg.norm(got[-1][0]["location"] - got[0][0]["location"])
  assert moved > 0.03  # 5 steps (0.25 s) from a standstill


def test_nav_env_reward_and_done_on_arrival():
  config = dict(NAV_KWARGS, destination=NAV_KWARGS["origin"])
  jenv = JaxCARLANavEnv(**config)
  tenv = CARLANavEnv(**config, device="cpu")
  for env in (jenv, tenv):
    env.seed(SEED)
    env.reset()
  _, wr, wd, _ = jenv.step(ACTIONS[0])
  _, gr, gd, _ = tenv.step(ACTIONS[0])
  assert (gr, gd) == (wr, wd) == (1.0, True)


# -- the single-scene agents --------------------------------------------------------


def _assert_actions_close(got: CARLAAction, want: CARLAAction) -> None:
  """Throttle, steer and brake within the policies' ACTION_ATOL."""
  diff = np.abs(got.as_array() - want.as_array())
  assert (diff <= ACTION_ATOL).all(), (got, want)


def test_autopilot_agent_matches():
  jenv, tenv = _nav_envs()
  jobs, tobs = jenv.reset(), tenv.reset()
  jagent, tagent = JaxAutopilotAgent(jenv), AutopilotAgent(tenv)
  actions = []
  for _ in range(5):
    ja, ta = jagent.act(jobs), tagent.act(tobs)
    _assert_actions_close(ta, ja)
    actions.append(ta.as_array())
    jobs, _, _, _ = jenv.step(ja)
    tobs, _, _, _ = tenv.step(ta)
  np.testing.assert_allclose(tobs["location"], jobs["location"], rtol=0,
                             atol=STATE_ATOL)
  assert np.abs(actions).sum() > 0


def test_blind_agent_drives():
  env = FiniteHorizonWrapper(
      CARLANavEnv(**NAV_KWARGS, device="cpu"), max_episode_steps=10)
  results = EnvironmentLoop(BlindAgent, env,
                            metrics=[StepsMetric(), DistanceMetric()]).run()
  assert results["steps"] == 10 and results["distance"] > 0.0


@pytest.fixture(scope="module")
def observation():
  """One observation of the JAX env (default sensors), fed to both
  agents; the port's agents act on an env of their own."""
  jenv, _ = _nav_envs()
  jenv.reset()
  for action in ACTIONS:
    obs, _, _, _ = jenv.step(action)
  return obs


def _compare_agents(jagent, tagent, observation):
  """The ego-frame plans (40 interpolated points) and the actions."""
  want = np.asarray(jagent(dict(observation)))
  got = np.asarray(tagent(dict(observation)))
  assert got.shape == want.shape
  # The plans agree to ~1e-5 m (tests/test_torch_policies.py).
  np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
  _assert_actions_close(tagent.act(observation), jagent.act(observation))


def _agent_envs():
  jenv, tenv = _nav_envs(warmup_steps=0, num_vehicles=0)
  jenv.reset()
  tenv.reset()
  return jenv, tenv


def test_dim_agent_matches(observation):
  jm, tree = _jax_dim(0)
  jenv, tenv = _agent_envs()
  tm = convert.load(tmodels.ImitativeModel(device="cpu"), tree)
  _compare_agents(JaxDIMAgent(jenv, model=jm, params=tree),
                  DIMAgent(tenv, model=tm), observation)


def test_rip_agent_matches(observation):
  members = [_jax_dim(seed) for seed in (0, 1)]
  jenv, tenv = _agent_envs()
  trees = [tree for _, tree in members]
  models = convert.load_ensemble(
      [tmodels.ImitativeModel(device="cpu") for _ in trees], trees)
  _compare_agents(
      JaxRIPAgent(jenv, algorithm="WCM", model=members[0][0],
                  params_list=trees),
      RIPAgent(tenv, algorithm="WCM", models=models), observation)


def test_cil_agent_matches(observation):
  jm = jmodels.BehaviouralModel()
  ctx = dict(dim_context(1, 0), mode=np.zeros((1, 1), np.float32))
  import jax.numpy as jnp  # pylint: disable=import-outside-toplevel
  tree = random_tree(jm, **{k: jnp.asarray(v) for k, v in ctx.items()})
  jenv, tenv = _agent_envs()
  tm = convert.load(tmodels.BehaviouralModel(device="cpu"), tree)
  _compare_agents(JaxCILAgent(jenv, model=jm, params=tree),
                  CILAgent(tenv, model=tm), observation)
