"""The compiled rollout of the port on the CPU: the static-buffer step that
a card captures into a CUDA graph (``graphs.CapturedStep``) against the
private eager loops it replaced, exactly, and against the JAX package's
jitted ``lax.scan`` within the rollout tolerances of
``tests/test_torch_batched.py``.

On the CPU the step runs eagerly every call.  ``FakeCapturedStep`` plays
the card's capture and replay on the CPU: the capture runs the step once
(the wrapper runs, as a real capture runs it), its first replay does
nothing (the capture's run took its place) and every later replay runs
the step and writes the results into the captured outputs in place, with
the launch counters as a replay leaves them.  So the runner's counting
and output handling are checked without a card."""

import numpy as np
import pytest
import torch

from oatomobile_torch import graphs
from oatomobile_torch.baselines.learned.dim.policy import make_dim_policy
from oatomobile_torch.baselines.learned.rip.policy import make_rip_policy
from oatomobile_torch.benchmarks import batched_eval as teval
from oatomobile_torch.benchmarks.corl2017.benchmark import _TASKS
from oatomobile_torch.datasets.carla import _resize_quantize
from oatomobile_torch.envs.batched import BatchedEnv
from oatomobile_torch.models import ImitativeModel
from oatomobile_torch.native import nvcc
from oatomobile_torch.ops import (bev_cuda, depthwise_cuda, dim_plan_cuda,
                                  group_norm_cuda)
from oatomobile_torch.sim import autopilot_policy
from oatomobile_torch.sim.types import scene_state_to_numpy
from oatomobile_tpu.envs.batched import BatchedEnv as JaxBatchedEnv
from torch_port_helpers import flatten

torch.set_num_threads(1)

TOWN = "Town02"
LIDAR = ("lidar",)
# Autopilot with the LIDAR computed, 8 NPCs and a horizon short enough
# that auto-reset fires inside 30 steps.
AUTOPILOT = dict(num_vehicles=8, seed=4, max_episode_steps=12)
# Collection: no auto-reset, the autopilot's epsilon-noise, the LIDAR
# resized and quantised each step.
COLLECT_SENSORS = ("collision", "control", "lidar", "location", "rotation",
                   "traffic_light_state", "velocity")
NOISE = 0.2


def _noisy(params, state):
  return autopilot_policy(params, state, noise=NOISE)


def _quantise(obs):
  out = dict(obs)
  out["lidar"] = _resize_quantize(obs["lidar"], (50, 50))
  return out


def assert_trees_equal(got, want):
  if isinstance(want, dict):
    got, want = flatten(got), flatten(want)
    assert set(got) == set(want)
    for k in want:
      assert got[k].dtype == want[k].dtype, k
      np.testing.assert_array_equal(got[k], want[k], err_msg=k)
  else:
    assert got == want


def _np(d):
  return {k: v.numpy() for k, v in d.items()} if d else d


def _run(env, runner, steps, **kwargs):
  """(final state, collected, stats) of ``env``'s rollout (runner) or its
  private eager loop, as numpy."""
  fn = env.rollout if runner else env._rollout_eager  # pylint: disable=protected-access
  final, collected, stats = fn(steps, **kwargs)
  return scene_state_to_numpy(final), _np(collected), _np(stats)


class _FakeGraph:

  def __init__(self, fn, outputs):
    self._fn, self._outputs, self._skip = fn, outputs, True

  def replay(self):
    if self._skip:  # the capture ran this step
      self._skip = False
      return
    counts = {kernel: kernel.launches for kernel in nvcc.KERNELS}
    _copy_into(self._outputs, self._fn())
    for kernel, n in counts.items():
      kernel.launches = n  # a replay runs no Python


def _copy_into(dst, src):
  if isinstance(dst, torch.Tensor):
    dst.copy_(src)
  elif isinstance(dst, dict):
    for k in dst:
      _copy_into(dst[k], src[k])
  elif isinstance(dst, (tuple, list)):
    for d, s in zip(dst, src):
      _copy_into(d, s)


class FakeCapturedStep(graphs.CapturedStep):
  """``CapturedStep`` with the card's capture and replay played on the
  CPU (see the module docstring)."""

  instances = []

  def __init__(self, fn, device, pool=None):
    super().__init__(fn, device, pool)
    self._cuda = True
    FakeCapturedStep.instances.append(self)

  def _run_on_side_stream(self):
    return self._fn()

  def _record(self):
    outputs = self._fn()
    return _FakeGraph(self._fn, outputs), outputs


@pytest.fixture
def fake_card(monkeypatch):
  """The fake capture in place of the real one, and splat, planner,
  GroupNorm and depthwise wrappers that count their CPU calls as the
  card's wrappers count launches (the encoder routes float32 no-grad
  forwards to the GroupNorm and depthwise wrappers as it does on the
  card)."""
  reference = bev_cuda.splat_lidar_batch_reference
  plan = dim_plan_cuda.plan
  group_norm = group_norm_cuda.group_norm
  depthwise = depthwise_cuda.depthwise

  def counting_splat(*inputs):
    bev_cuda.KERNEL.launches += 1
    return reference(*inputs)

  def counting_plan(*args, **kwargs):
    dim_plan_cuda.KERNEL.launches += 1
    return plan(*args, **kwargs)

  def counting_group_norm(*args, **kwargs):
    group_norm_cuda.KERNEL.launches += 1
    return group_norm(*args, **kwargs)

  def counting_depthwise(*args, **kwargs):
    depthwise_cuda.KERNEL.launches += 1
    return depthwise(*args, **kwargs)

  def engages_on_cpu(x):
    return x.dtype == torch.float32 and not torch.is_grad_enabled()

  monkeypatch.setattr(graphs, "CapturedStep", FakeCapturedStep)
  monkeypatch.setattr(bev_cuda, "splat_lidar_batch", counting_splat)
  monkeypatch.setattr(bev_cuda.KERNEL, "launches", 0)
  monkeypatch.setattr(dim_plan_cuda, "plan", counting_plan)
  monkeypatch.setattr(dim_plan_cuda.KERNEL, "launches", 0)
  monkeypatch.setattr(group_norm_cuda, "group_norm", counting_group_norm)
  monkeypatch.setattr(group_norm_cuda, "engages", engages_on_cpu)
  monkeypatch.setattr(group_norm_cuda.KERNEL, "launches", 0)
  monkeypatch.setattr(depthwise_cuda, "depthwise", counting_depthwise)
  monkeypatch.setattr(depthwise_cuda, "engages", engages_on_cpu)
  monkeypatch.setattr(depthwise_cuda.KERNEL, "launches", 0)
  FakeCapturedStep.instances = []
  return FakeCapturedStep.instances


# -- the runner against the eager loop, exactly ----------------------------


@pytest.mark.parametrize("card", [False, True], ids=["cpu", "fake_card"])
def test_autopilot_rollout_equals_eager(card, request):
  if card:
    request.getfixturevalue("fake_card")
  runner, eager = (BatchedEnv(TOWN, 3, device="cpu", **AUTOPILOT)
                   for _ in range(2))
  got = _run(runner, True, 30, compute=LIDAR)
  want = _run(eager, False, 30, compute=LIDAR)
  for g, w in zip(got, want):
    assert_trees_equal(g, w)
  assert got[2]["episodes"].sum() >= 3  # auto-reset fired
  assert (got[2]["obs_checksum"] > 0).all()


@pytest.mark.parametrize("card", [False, True], ids=["cpu", "fake_card"])
def test_collection_rollout_equals_eager(card, request):
  if card:
    request.getfixturevalue("fake_card")
  kwargs = dict(num_vehicles=6, seed=3, sensors=COLLECT_SENSORS,
                auto_reset=False)
  runner, eager = (BatchedEnv(TOWN, 3, device="cpu", **kwargs)
                   for _ in range(2))
  rollout = dict(policy=_noisy, collect=COLLECT_SENSORS,
                 collect_transform=_quantise)
  got = _run(runner, True, 20, **rollout)
  want = _run(eager, False, 20, **rollout)
  for g, w in zip(got, want):
    assert_trees_equal(g, w)
  collected = got[1]
  assert set(collected) == set(COLLECT_SENSORS)
  assert collected["lidar"].shape == (20, 3, 50, 50, 2)
  assert collected["lidar"].dtype == np.uint8
  # The noise's uniform actions show in the applied controls.
  assert (collected["control"][..., 1] != 0).any()


@pytest.mark.parametrize("card", [False, True], ids=["cpu", "fake_card"])
def test_evaluator_metrics_equal_eager(card, request):
  if card:
    request.getfixturevalue("fake_card")
  configs = [_TASKS[t] for t in ("Town02_Straight0-v0", "Town02_Turn0-v0")]
  params, states = teval.town_group_scenes(TOWN, configs, num_episodes=2,
                                           seed=1, device="cpu")

  def policy(p, s):
    return autopilot_policy(p, s, noise=0.1)

  before = scene_state_to_numpy(states)
  with torch.no_grad():
    final, got = teval._episode_metrics_rollout(params, states, policy, 25)  # pylint: disable=protected-access
    final_e, want = teval._episode_metrics_rollout_eager(  # pylint: disable=protected-access
        params, states, policy, 25)
  assert_trees_equal(_np(got), _np(want))
  assert_trees_equal(scene_state_to_numpy(final),
                     scene_state_to_numpy(final_e))
  # The caller's states are left as they were.
  assert_trees_equal(scene_state_to_numpy(states), before)
  assert (got["steps"] > 0).all() and (got["distance"] > 0).all()


def test_dim_policy_rollout_equals_eager(fake_card):
  # A narrow DIM (32x32 input) planning 3 Adam steps, the planner (its
  # plain version on the CPU) inside the step.
  def policy():
    return make_dim_policy(ImitativeModel(
        (4, 2), (32, 32), generator=torch.Generator().manual_seed(0),
        device="cpu"), num_plan_steps=3)

  kwargs = dict(num_vehicles=4, seed=1)
  runner, eager = (BatchedEnv(TOWN, 2, device="cpu", **kwargs)
                   for _ in range(2))
  got = _run(runner, True, 5, policy=policy())
  assert len(fake_card) == 1 and fake_card[0].captured
  assert bev_cuda.KERNEL.launches == 5  # the policy's LIDAR, once a step
  assert dim_plan_cuda.KERNEL.launches == 5  # the plan, once a step
  assert group_norm_cuda.KERNEL.launches == 5 * 52  # the encoder's norms
  assert depthwise_cuda.KERNEL.launches == 5 * 17  # its depthwise layers
  want = _run(eager, False, 5, policy=policy())
  for g, w in zip(got, want):
    assert_trees_equal(g, w)
  assert (got[2]["distance"] > 0).all()


def test_rip_policy_rollout_equals_eager(fake_card):
  # K = 4 narrow DIMs (32x32 input) planning 2 Adam steps over autograd.
  def policy():
    return make_rip_policy([ImitativeModel(
        (4, 2), (32, 32), generator=torch.Generator().manual_seed(k),
        device="cpu") for k in range(4)], num_plan_steps=2)

  kwargs = dict(num_vehicles=4, seed=2)
  runner, eager = (BatchedEnv(TOWN, 2, device="cpu", **kwargs)
                   for _ in range(2))
  got = _run(runner, True, 3, policy=policy())
  assert len(fake_card) == 1 and fake_card[0].captured
  assert bev_cuda.KERNEL.launches == 3
  assert dim_plan_cuda.KERNEL.launches == 0  # RIP plans over autograd
  assert group_norm_cuda.KERNEL.launches == 3 * 4 * 52  # four encoders a step
  assert depthwise_cuda.KERNEL.launches == 3 * 4 * 17
  want = _run(eager, False, 3, policy=policy())
  for g, w in zip(got, want):
    assert_trees_equal(g, w)


# -- against the JAX package's compiled rollout ------------------------------


def test_autopilot_rollout_with_resets_matches_jax():
  jenv = JaxBatchedEnv(TOWN, 3, **AUTOPILOT)
  tenv = BatchedEnv(TOWN, 3, device="cpu", **AUTOPILOT)
  jfinal, _, want = jenv.rollout(30, compute=LIDAR)
  tfinal, _, got = tenv.rollout(30, compute=LIDAR)
  want = {k: np.asarray(v) for k, v in want.items()}
  got = _np(got)
  np.testing.assert_array_equal(got["episodes"], want["episodes"])
  np.testing.assert_array_equal(got["collisions"], want["collisions"])
  assert got["episodes"].sum() >= 3
  # As tests/test_torch_batched.py: metres of travel to 1e-3, the checksum
  # of 30 x 80,000 BEV values to 1e-3 relative.
  np.testing.assert_allclose(got["distance"], want["distance"], rtol=0,
                             atol=1e-3)
  np.testing.assert_allclose(got["obs_checksum"], want["obs_checksum"],
                             rtol=1e-3)
  # The reset key streams are the JAX package's, bit for bit.
  np.testing.assert_array_equal(scene_state_to_numpy(tfinal)["rng"],
                                np.asarray(jfinal.rng))


def test_collection_rollout_matches_jax():
  keys = ("collision", "control", "location")
  kwargs = dict(num_vehicles=4, seed=6, sensors=keys, auto_reset=False)
  _, want, _ = JaxBatchedEnv(TOWN, 2, **kwargs).rollout(12, collect=keys)
  _, got, _ = BatchedEnv(TOWN, 2, device="cpu", **kwargs).rollout(
      12, collect=keys)
  for key in keys:
    w, g = np.asarray(want[key]), got[key].numpy()
    assert g.shape == w.shape == (12, 2) + w.shape[2:], key
    assert g.dtype == w.dtype, key
    # As tests/test_torch_batched.py: 12 steps of positions of ~100 m.
    np.testing.assert_allclose(g, w, rtol=0, atol=1e-4, err_msg=key)


# -- the static buffers ---------------------------------------------------------


@pytest.mark.parametrize("card", [False, True], ids=["cpu", "fake_card"])
def test_two_rollouts_of_15_equal_one_of_30(card, request):
  if card:
    request.getfixturevalue("fake_card")
  one, two = (BatchedEnv(TOWN, 3, device="cpu", **AUTOPILOT)
              for _ in range(2))
  final, _, stats = one.rollout(30, compute=LIDAR)
  _, _, first = two.rollout(15, compute=LIDAR)
  final2, _, second = two.rollout(15, compute=LIDAR)
  assert_trees_equal(scene_state_to_numpy(final2),
                     scene_state_to_numpy(final))
  for key in ("episodes", "collisions"):
    np.testing.assert_array_equal((first[key] + second[key]).numpy(),
                                  stats[key].numpy())
  np.testing.assert_allclose((first["distance"] + second["distance"]).numpy(),
                             stats["distance"].numpy(), rtol=1e-6)


@pytest.mark.parametrize("card", [False, True], ids=["cpu", "fake_card"])
def test_returned_state_and_stats_survive_a_later_rollout(card, request):
  if card:
    request.getfixturevalue("fake_card")
  env = BatchedEnv(TOWN, 2, device="cpu", **AUTOPILOT)
  final, _, stats = env.rollout(6)
  held_state = scene_state_to_numpy(final)
  held_stats = _np({k: v.clone() for k, v in stats.items()})
  looked = env.state
  held_look = scene_state_to_numpy(looked)
  env.rollout(6)
  env.step(np.tile(np.float32([0.5, 0.0, 0.0]), (2, 1)))
  assert_trees_equal(scene_state_to_numpy(final), held_state)
  assert_trees_equal(_np(stats), held_stats)
  assert_trees_equal(scene_state_to_numpy(looked), held_look)
  assert not np.array_equal(scene_state_to_numpy(env.state)["hero_xy"],
                            held_state["hero_xy"])


def test_reset_restores_the_initial_state():
  env = BatchedEnv(TOWN, 3, device="cpu", **AUTOPILOT)
  initial = scene_state_to_numpy(env.state)
  env.rollout(20)  # auto-reset reads the initial state on the way
  assert not np.array_equal(scene_state_to_numpy(env.state)["hero_xy"],
                            initial["hero_xy"])
  obs = env.reset()
  assert_trees_equal(scene_state_to_numpy(env.state), initial)
  np.testing.assert_array_equal(obs["location"][:, :2].numpy(),
                                initial["hero_xy"])
  # After a reset the rollout repeats itself.
  _, _, a = env.rollout(20, compute=LIDAR)
  env.reset()
  _, _, b = env.rollout(20, compute=LIDAR)
  assert_trees_equal(_np(a), _np(b))


def test_step_through_the_runner_equals_functional_steps(fake_card):
  env = BatchedEnv(TOWN, 2, device="cpu", **AUTOPILOT)
  ref = BatchedEnv(TOWN, 2, device="cpu", **AUTOPILOT)
  state = ref.state
  actions = np.tile(np.float32([0.7, 0.1, 0.0]), (2, 1))
  from oatomobile_torch.sim import world_step  # pylint: disable=import-outside-toplevel
  for _ in range(15):
    obs, done = env.step(actions)
    new = world_step(ref.params, state, torch.as_tensor(actions))
    want_done = ref._done(new)  # pylint: disable=protected-access
    np.testing.assert_array_equal(obs["location"][:, :2].numpy(),
                                  new.hero_xy.numpy())
    np.testing.assert_array_equal(done.numpy(), want_done.numpy())
    state = ref._reset_where_done(new, want_done)  # pylint: disable=protected-access
  assert_trees_equal(scene_state_to_numpy(env.state),
                     scene_state_to_numpy(state))
  assert len(fake_card) == 1 and fake_card[0].captured


# -- launch counts under replay ----------------------------------------------


def test_capture_counts_launches_per_replay(fake_card):
  del fake_card
  calls = []

  def step():
    calls.append(1)
    bev_cuda.KERNEL.launches += 2  # a step that launches two kernels

  run = graphs.CapturedStep(step, "cuda")
  for i in range(6):
    run()
    assert bev_cuda.KERNEL.launches == 2 * (i + 1)
    assert run.captured == (i >= graphs.WARMUP_STEPS)


@pytest.mark.parametrize("made", ["inside", "after"])
def test_capture_counts_a_kernel_made_inside_or_after_it(fake_card,
                                                         monkeypatch, made):
  """The runner keeps a capture's launches by ``Kernel``: one first made
  inside the capture counts at each replay; one made after it is not in
  the graph, and a replay counts none of its launches."""
  del fake_card
  monkeypatch.setattr(nvcc, "KERNELS", list(nvcc.KERNELS))
  late, calls = [], []

  def make():
    late.append(nvcc.Kernel("late", "late.cu", (), lambda lib: lib))

  def step():
    calls.append(1)
    bev_cuda.KERNEL.launches += 1
    if made == "inside" and len(calls) == graphs.WARMUP_STEPS + 1:
      make()
    if late:
      late[0].launches += 1

  run = graphs.CapturedStep(step, "cuda")
  for _ in range(graphs.WARMUP_STEPS + 1):
    run()
  assert run.captured
  if made == "after":
    make()
  for _ in range(3):
    run()
  assert bev_cuda.KERNEL.launches == graphs.WARMUP_STEPS + 4
  assert late[0].launches == (4 if made == "inside" else 0)


@pytest.mark.parametrize("steps", [1, 2, 3, 30])
def test_splat_launches_once_a_step_under_replay(fake_card, steps):
  env = BatchedEnv(TOWN, 2, device="cpu", **AUTOPILOT)
  env.rollout(steps, compute=LIDAR)
  assert bev_cuda.KERNEL.launches == steps
  bev_cuda.KERNEL.launches = 0
  env.rollout(steps, compute=LIDAR)  # the cached graph's replays
  assert bev_cuda.KERNEL.launches == steps
  assert len(fake_card) == 1
  assert fake_card[0].captured == (2 * steps > graphs.WARMUP_STEPS)
  bev_cuda.KERNEL.launches = 0
  env.rollout(steps)  # nothing computed: another graph, no splat
  assert bev_cuda.KERNEL.launches == 0 and len(fake_card) == 2


def test_no_public_switch_chooses_eager():
  # As the JAX package has no eager option: rollout's signature is the
  # JAX package's.
  import inspect  # pylint: disable=import-outside-toplevel
  got = list(inspect.signature(BatchedEnv.rollout).parameters)
  want = list(inspect.signature(JaxBatchedEnv.rollout).parameters)
  assert got == want
