"""The CUDA kernels of oatomobile_torch against their plain versions, on
the card.  Marked ``cuda``: skipped where no CUDA device and nvcc exist
(run them on a card with
``python -m pytest --noconftest tests/test_torch_cuda.py``: the tests'
conftest sets up JAX, which a card's machine need not have)."""

import os
import shutil

import pytest
import torch

from oatomobile_torch.envs.batched import BatchedEnv
from oatomobile_torch.ops import bev, bev_cuda

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device")
  if not (shutil.which("nvcc") or
          os.path.exists("/usr/local/cuda/bin/nvcc")):
    pytest.skip("needs nvcc to build the kernels")
  return torch.device("cuda")


@pytest.mark.parametrize("town,vehicles,pedestrians",
                         [("Town01", 16, 0), ("Town03", 24, 16)])
def test_bev_splat_kernel_matches_plain_version(card, town, vehicles,
                                                pedestrians):
  env = BatchedEnv(town, 16, num_vehicles=vehicles,
                   num_pedestrians=pedestrians, seed=1, device=card)
  env.rollout(10, compute=())
  inputs = bev.gather_inputs(env.params, env.state)
  before = bev_cuda.launches
  out = bev_cuda.splat_lidar_batch(*inputs)
  assert bev_cuda.launches == before + 1
  ref = bev_cuda.splat_lidar_batch_reference(*inputs)
  torch.cuda.synchronize()
  # Same float32 roundings (no FMA in the kernel) and conservative culling
  # boxes: equal bit for bit.
  assert torch.equal(out, ref)


@pytest.mark.parametrize("batch", [64, 1024])
def test_bev_splat_kernel_matches_plain_version_on_stress_inputs(card,
                                                                 batch):
  inputs = bev_cuda.stress_inputs(batch, 7 + batch, card)
  out = bev_cuda.splat_lidar_batch(*inputs)
  ref = bev_cuda.splat_lidar_batch_reference(*inputs)
  torch.cuda.synchronize()
  assert int((out != ref).any(-1).sum()) == 0
  assert (ref[..., 1] > 0).any() and (ref[..., 0] > 0).any()


def test_bev_splat_graph_replay_matches_eager_call(card):
  static = [x.clone() for x in bev_cuda.stress_inputs(64, 1, card)]
  bev_cuda.splat_lidar_batch(*static)
  torch.cuda.synchronize()
  graph = torch.cuda.CUDAGraph()
  with torch.cuda.graph(graph):
    captured = bev_cuda.splat_lidar_batch(*static)
  fresh = bev_cuda.stress_inputs(64, 2, card)
  for dst, src in zip(static, fresh):
    dst.copy_(src)
  graph.replay()
  eager = bev_cuda.splat_lidar_batch(*fresh)
  torch.cuda.synchronize()
  assert torch.equal(captured, eager)
  assert torch.equal(captured, bev_cuda.splat_lidar_batch_reference(*fresh))


def test_bev_splat_kernel_refuses_a_misaligned_output(card):
  """The C entry point checks what the bulk copies need."""
  inputs = bev_cuda.stress_inputs(2, 0, card)
  centers, counts, ground = bev_cuda._tables(card)  # pylint: disable=protected-access
  out = torch.empty(2 * 200 * 200 * 2 + 1, device=card)[1:]
  hero, walls, roads, boxes = inputs
  err = bev_cuda._library().bev_splat_launch(  # pylint: disable=protected-access
      hero.data_ptr(), walls.data_ptr(), walls.shape[1], roads.data_ptr(),
      roads.shape[1], boxes.data_ptr(), boxes.shape[1], centers.data_ptr(),
      counts.data_ptr(), ground.data_ptr(), out.data_ptr(), 2,
      torch.cuda.current_stream().cuda_stream)
  assert err != 0


def test_dim_policy_on_the_card_matches_the_cpu(card):
  """One DIM policy call on the same Town02 scenes and the same weights
  (one seeded generator) on the card and on the CPU.  TF32 is off, so the
  card's convolutions and GEMMs are float32 too; the two differ in
  summation order only.  Limits: the plan and the actions to 1e-3."""
  from oatomobile_torch.baselines.learned.dim.policy import make_dim_policy
  from oatomobile_torch.models import ImitativeModel
  tf32 = (torch.backends.cuda.matmul.allow_tf32,
          torch.backends.cudnn.allow_tf32)
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  try:
    out = {}
    for device in ("cpu", card):
      env = BatchedEnv("Town02", 4, num_vehicles=8, seed=4, device=device)
      env.rollout(5)
      model = ImitativeModel(generator=torch.Generator().manual_seed(0),
                             device=device)
      policy = make_dim_policy(model)
      obs = policy.observe(env.params, env.state)
      plan = policy.plan(policy.encode(obs), obs)
      actions, _ = policy.act(env.params, env.state, plan, obs)
      out[str(device)] = (plan.cpu(), actions.cpu())
    (plan_c, act_c), (plan_g, act_g) = out["cpu"], out["cuda"]
    assert float((plan_c - plan_g).abs().max()) < 1e-3
    assert float((act_c - act_g).abs().max()) < 1e-3
  finally:
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32


def test_captured_rollout_equals_the_eager_loop(card):
  """The rollout's step captured into a CUDA graph and replayed, against
  the private eager loop on the card: the same kernels, so equal bit for
  bit; one splat launch a step, counted under replay."""
  kwargs = dict(num_vehicles=8, seed=4, max_episode_steps=12)
  graph, eager = (BatchedEnv("Town02", 4, device=card, **kwargs)
                  for _ in range(2))
  before = bev_cuda.launches
  final, _, stats = graph.rollout(30, compute=("lidar",))
  assert bev_cuda.launches == before + 30
  final_e, _, stats_e = eager._rollout_eager(30, compute=("lidar",))  # pylint: disable=protected-access
  for key in stats:
    assert torch.equal(stats[key], stats_e[key]), key
  assert torch.equal(final.hero_xy, final_e.hero_xy)
  assert torch.equal(final.rng, final_e.rng)
  assert int(stats["episodes"].sum()) > 0


def test_capture_survives_a_stale_graph_in_a_reference_cycle(card):
  """An env and its captured step form a reference cycle, so a dropped env
  keeps its CUDA graph until the collector runs; a collection during
  another capture would destroy that graph and invalidate the capture.
  With the collector at its most eager, the next capture still holds."""
  import gc
  old = BatchedEnv("Town02", 4, num_vehicles=8, seed=1, device=card)
  old.rollout(4, compute=("lidar",))
  del old
  thresholds = gc.get_threshold()
  gc.set_threshold(1, 1, 1)
  try:
    env = BatchedEnv("Town02", 4, num_vehicles=8, seed=2, device=card)
    _, _, stats = env.rollout(6, compute=("lidar",))
    torch.cuda.synchronize()
  finally:
    gc.set_threshold(*thresholds)
  assert bool((stats["obs_checksum"] > 0).all())


def test_a_captured_step_marks_its_replays_on_the_device_clock(card):
  import gc  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.utils import profiling  # pylint: disable=import-outside-toplevel
  parts = ("autopilot", "world_step", "sensors", "bookkeeping")
  profiling.reset()
  env = BatchedEnv("Town01", 64, num_vehicles=4, seed=2, device=card)
  for _ in range(3):
    _, _, stats = env.rollout(4, compute=("lidar",))
    stats["distance"].cpu()
  snap = profiling.snapshot()
  # The first call warms two steps eagerly, captures the third and
  # replays from there; each call's last replay is read once.
  for name in parts:
    origins = [s.origin for s in snap[name]["samples"]]
    assert origins.count("eager") == 2 and origins.count("replay") == 3
    assert all(s.ms > 0.0 for s in snap[name]["samples"])
  issues = [s for s in snap["rollout.issue"]["samples"]
            if s.origin == "replay"]
  assert [s.index for s in issues] == [1, 2]
  for issue in issues:
    step = sum(s.ms for name in parts for s in snap[name]["samples"]
               if s.origin == "replay" and s.index == issue.index)
    assert 0.5 < step / (issue.ms / issue.count) < 1.5
    assert 0.0 <= issue.gap_ms < issue.period_ms
  # A freed graph's marks stay readable, and a new graph's are read.
  del env
  gc.collect()
  env = BatchedEnv("Town01", 64, num_vehicles=4, seed=3, device=card)
  for _ in range(2):
    _, _, stats = env.rollout(4, compute=("lidar",))
    stats["distance"].cpu()
  snap = profiling.snapshot()
  assert [s.origin for s in snap["world_step"]["samples"]].count(
      "replay") == 5
  profiling.reset()
