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
  before = bev_cuda.KERNEL.launches
  out = bev_cuda.splat_lidar_batch(*inputs)
  assert bev_cuda.KERNEL.launches == before + 1
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
  err = bev_cuda.KERNEL.library().bev_splat_launch(
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
  before = bev_cuda.KERNEL.launches
  final, _, stats = graph.rollout(30, compute=("lidar",))
  assert bev_cuda.KERNEL.launches == before + 30
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


# -- The DIM planner kernel --------------------------------------------------

# The planner at the DIM path's width: 1024 Town01 scenes, 20 Adam steps.
PLAN = dict(num_steps=20, lr=5e-2, epsilon=1.0, horizon=4)


def _dim_plan_inputs(card, scenes: int, seed: int):
  """(model, flow weights, z, goals) of a DIM policy with weights from one
  seeded generator on a Town01 scene batch after 5 autopilot steps."""
  from oatomobile_torch.baselines.learned.dim.policy import make_dim_policy  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.models import ImitativeModel  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.ops import dim_plan_cuda  # pylint: disable=import-outside-toplevel
  env = BatchedEnv("Town01", scenes, num_vehicles=16, route_capacity=1024,
                   seed=seed, device=card)
  env.rollout(5)
  policy = make_dim_policy(ImitativeModel(
      generator=torch.Generator().manual_seed(seed), device=card))
  obs = policy.observe(env.params, env.state)
  return (policy.model, dim_plan_cuda.flow_weights(policy.model.decoder),
          policy.encode(obs), obs.goal)


@pytest.mark.parametrize("seed", [0, 1])
def test_dim_plan_kernel_matches_plain_version_and_autograd(card, seed):
  """At 1024 scenes the kernel's plan equals the autograd path's bit for
  bit (it repeats cuBLAS's and autograd's sums at these shapes), best
  iterates and all.  The plain version sums in other orders on the card,
  so a scene whose first Adam step (lr * sign(g)) or best iterate sits on
  a rounding may part from it: at most 3 scenes of 1024 further than
  1e-4 m or on another best iterate."""
  from oatomobile_torch.models import dim  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.ops import dim_plan_cuda  # pylint: disable=import-outside-toplevel
  model, weights, z, goal = _dim_plan_inputs(card, 1024, seed)
  out, best = dim_plan_cuda.plan(weights, z, goal, **PLAN)
  auto, auto_best = dim.autograd_plan(model, z, PLAN["num_steps"], goal,
                                      PLAN["lr"], PLAN["epsilon"])
  plain, plain_best = dim_plan_cuda.plan_reference(weights, z, goal, **PLAN)
  torch.cuda.synchronize()
  assert torch.equal(out, auto) and torch.equal(best, auto_best)
  apart = (((out - plain).abs().amax((1, 2)) > 1e-4) | (best != plain_best))
  assert int(apart.sum()) <= 3
  assert bool(torch.isfinite(out).all()) and bool((best > 0).any())


def test_dim_plan_graph_replay_matches_eager_call(card):
  from oatomobile_torch.ops import dim_plan_cuda  # pylint: disable=import-outside-toplevel
  _, weights, z, goal = _dim_plan_inputs(card, 64, 3)
  _, _, z_new, goal_new = _dim_plan_inputs(card, 64, 4)
  z_static, goal_static = z.clone(), goal.clone()
  dim_plan_cuda.plan(weights, z_static, goal_static, **PLAN)
  torch.cuda.synchronize()
  graph = torch.cuda.CUDAGraph()
  with torch.cuda.graph(graph):
    captured, captured_best = dim_plan_cuda.plan(weights, z_static,
                                                 goal_static, **PLAN)
  z_static.copy_(z_new)
  goal_static.copy_(goal_new)
  graph.replay()
  eager, eager_best = dim_plan_cuda.plan(weights, z_new, goal_new, **PLAN)
  torch.cuda.synchronize()
  assert torch.equal(captured, eager)
  assert torch.equal(captured_best, eager_best)


def test_dim_plan_launches_once_a_plan(card):
  """One launch a ``plan_from_z`` call, and one a step of a captured DIM
  rollout (counted under replay); RIP's aggregated plan launches none."""
  from oatomobile_torch.baselines.learned.dim.policy import make_dim_policy  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.baselines.learned.rip.agent import rip_plan  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.ops import dim_plan_cuda  # pylint: disable=import-outside-toplevel
  model, _, z, goal = _dim_plan_inputs(card, 16, 5)
  before = dim_plan_cuda.KERNEL.launches
  model.plan_from_z(z, goal=goal, num_steps=3)
  assert dim_plan_cuda.KERNEL.launches == before + 1
  env = BatchedEnv("Town02", 4, num_vehicles=8, seed=4, device=card)
  policy = make_dim_policy(model)
  before = dim_plan_cuda.KERNEL.launches
  env.rollout(6, policy=policy)
  torch.cuda.synchronize()
  assert dim_plan_cuda.KERNEL.launches == before + 6
  obs = policy.observe(env.params, env.state)
  before = dim_plan_cuda.KERNEL.launches
  rip_plan([model, model], obs.goal, obs.context, num_steps=2)
  assert dim_plan_cuda.KERNEL.launches == before


def test_dim_plan_kernel_refuses_what_it_does_not_take(card):
  from oatomobile_torch.ops import dim_plan_cuda  # pylint: disable=import-outside-toplevel
  _, weights, z, goal = _dim_plan_inputs(card, 8, 6)
  before = dim_plan_cuda.KERNEL.launches
  with pytest.raises(ValueError):  # not contiguous
    dim_plan_cuda.plan(weights, z.t().contiguous().t(), goal, **PLAN)
  with pytest.raises(ValueError):
    dim_plan_cuda.plan(
        weights._replace(w_hh=weights.w_hh.t().contiguous().t()), z, goal,
        **PLAN)
  with pytest.raises(ValueError):  # a scalar on the host
    dim_plan_cuda.plan(weights, z, goal, **dict(PLAN, lr=torch.tensor(0.05)))
  with pytest.raises(ValueError):
    dim_plan_cuda.plan(weights, z, goal, **dict(PLAN, horizon=9))
  with pytest.raises(ValueError):
    dim_plan_cuda.plan(weights, z, goal, **dict(PLAN, num_steps=257))
  with pytest.raises(ValueError):
    dim_plan_cuda.plan(weights, z, goal.repeat(1, 4, 1), **PLAN)
  assert dim_plan_cuda.KERNEL.launches == before
  # The C entry point refuses what the wrapper would have.
  out = torch.empty(8, 4, 2, device=card)
  best = torch.empty(8, dtype=torch.int32, device=card)
  err = dim_plan_cuda.KERNEL.library().dim_plan_launch(
      z.data_ptr(), goal.data_ptr(), 40, *goal.stride(),
      *(w.data_ptr() for w in weights), None, 0.05, None, 1.0, 0.0, 7.35,
      1.84, 2.3, *dim_plan_cuda._host_tables(20), out.data_ptr(),  # pylint: disable=protected-access
      best.data_ptr(), 8, 4, 20, torch.cuda.current_stream().cuda_stream)
  assert err != 0


# -- The encoder's GroupNorm kernel ------------------------------------------


@pytest.mark.parametrize("batch,size", [(1024, 100), (1, 100), (64, 32),
                                        (64, 128)])
def test_group_norm_kernel_equals_pytorch_at_every_encoder_shape(
    card, batch, size):
  """Both thread regimes (rows of 128 to 20,000 floats at 100 x 100; the
  32 x 32 input reaches 1 x 1 maps; the 128 x 128 input's rows of 32,768
  floats are read twice): output, mean and rstd equal to F.group_norm
  (then F.relu6 or the residual add) and torch.native_group_norm bit for
  bit.  The shapes and inputs are chip_smoke.py's."""
  import chip_smoke  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.ops import group_norm_cuda as gn  # pylint: disable=import-outside-toplevel
  eps = 1e-6
  lib = gn.KERNEL.library()
  apart = []
  shapes = chip_smoke.encoder_norms(size)
  assert len(shapes) == chip_smoke.GROUP_NORM_PER_FORWARD
  for i, shape in enumerate(shapes):
    x, weight, bias, relu6, residual = chip_smoke.group_norm_case(batch,
                                                                  shape, i)
    c, h, w, _ = shape
    y, mean, rstd = gn.launch(lib, x, weight, bias, eps, relu6=relu6,
                              residual=residual,
                              stream=torch.cuda.current_stream().cuda_stream,
                              stats=True)
    want = gn.group_norm_reference(x, weight, bias, eps, relu6=relu6,
                                   residual=residual)
    _, want_mean, want_rstd = torch.native_group_norm(
        x, weight, bias, batch, c, h * w, c // gn.GROUP, eps)
    if not (torch.equal(y, want) and torch.equal(mean, want_mean) and
            torch.equal(rstd, want_rstd)):
      apart.append(shape)
  assert not apart


def test_encoder_z_equals_the_reference_bit_for_bit(card):
  """The DIM model's z through the GroupNorm and depthwise kernels (52 and
  17 launches) against the benchmark's plain reference model on the same seeded weights, their
  GroupNorms' scales and biases drawn anew."""
  from oatomobile_torch.models import ImitativeModel  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.ops import group_norm_cuda as gn  # pylint: disable=import-outside-toplevel
  from perfbench import weights as weights_lib  # pylint: disable=import-outside-toplevel
  from perfbench.reference.models.dim import ImitativeModel as RefModel  # pylint: disable=import-outside-toplevel
  weights = weights_lib.draw(RefModel(device="meta"), 2**31 + 5, card)
  g = torch.Generator(device=card).manual_seed(5)
  for name, w in weights.items():
    if "norm" in name:
      w.copy_((1 if name.endswith("weight") else 0) +
              0.5 * torch.randn(w.shape, generator=g, device=card))
  program = weights_lib.load(ImitativeModel(device="meta"), weights, card)
  reference = weights_lib.load(RefModel(device="meta"), weights, card)
  context = {"visual_features": torch.rand(1024, 2, 100, 100, generator=g,
                                           device=card),
             "velocity": torch.randn(1024, 3, generator=g, device=card),
             "is_at_traffic_light": torch.zeros(1024, 1, device=card),
             "traffic_light_state": torch.ones(1024, 1, device=card)}
  flags = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  from oatomobile_torch.ops import depthwise_cuda as dw  # pylint: disable=import-outside-toplevel
  try:
    with torch.no_grad():
      before = gn.KERNEL.launches, dw.KERNEL.launches
      z = program.params_z(**context)
      launched = (gn.KERNEL.launches - before[0],
                  dw.KERNEL.launches - before[1])
      want = reference.params_z(**context)
  finally:
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = flags
  assert launched == (52, 17)
  assert torch.equal(z, want)


def test_group_norm_graph_replay_matches_eager_call(card):
  import chip_smoke  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.ops import group_norm_cuda as gn  # pylint: disable=import-outside-toplevel
  shape = (24, 25, 25, "residual")
  static = list(chip_smoke.group_norm_case(64, shape, 1))
  args = dict(relu6=static[3], residual=static[4])
  gn.group_norm(*static[:3], 1e-6, **args)
  torch.cuda.synchronize()
  graph = torch.cuda.CUDAGraph()
  with torch.cuda.graph(graph):
    captured = gn.group_norm(*static[:3], 1e-6, **args)
  static[0].copy_(chip_smoke.group_norm_case(64, shape, 2)[0])
  graph.replay()
  eager = gn.group_norm(*static[:3], 1e-6, **args)
  torch.cuda.synchronize()
  assert torch.equal(captured, eager)


def test_group_norm_launches_only_without_autograd(card):
  from oatomobile_torch.baselines.learned.dim.policy import encoder_copy  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.models import ImitativeModel  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.ops import group_norm_cuda as gn  # pylint: disable=import-outside-toplevel
  model = ImitativeModel(device=card).requires_grad_(False)
  x = torch.rand(4, 2, 100, 100, device=card)
  before = gn.KERNEL.launches
  with torch.no_grad():
    model.encoder(x)
  assert gn.KERNEL.launches == before + 52
  model.encoder(x)  # autograd on: the plain path
  with torch.no_grad():
    encoder_copy(model, "bfloat16").encoder(x.to(torch.bfloat16))
  assert gn.KERNEL.launches == before + 52
  with torch.no_grad():  # rows past 20,480 floats: the kernel still
    model.encoder(torch.rand(2, 2, 128, 128, device=card))
  assert gn.KERNEL.launches == before + 104


def test_group_norm_kernel_refuses_what_it_does_not_take(card):
  from oatomobile_torch.ops import group_norm_cuda as gn  # pylint: disable=import-outside-toplevel
  x = torch.randn(2, 16, 5, 5, device=card)
  w, b = torch.ones(16, device=card), torch.zeros(16, device=card)
  before = gn.KERNEL.launches
  with pytest.raises(ValueError):
    gn.group_norm(x.transpose(2, 3), w, b, 1e-6)
  with pytest.raises(ValueError):
    gn.group_norm(x[:, :12].contiguous(), w[:12], b[:12], 1e-6)
  with pytest.raises(TypeError):
    gn.group_norm(x.double(), w, b, 1e-6)
  with pytest.raises(ValueError):
    gn.group_norm(x, w.cpu(), b, 1e-6)
  assert gn.KERNEL.launches == before
  # The entry point refuses the residual epilogue without a residual.
  y = torch.empty_like(x)
  err = gn.KERNEL.library().group_norm_launch(
      x.data_ptr(), w.data_ptr(), b.data_ptr(), None, y.data_ptr(), None,
      None, 4, 2, 25, 1e-6, 2, torch.cuda.current_stream().cuda_stream)
  assert err != 0


# -- The encoder's depthwise kernel --------------------------------------------


@pytest.mark.parametrize("batch,size", [(1024, 100), (1, 100), (1024, 32),
                                        (1024, 128)])
def test_depthwise_kernel_equals_pytorch_at_every_encoder_shape(
    card, batch, size):
  """Every depthwise layer's shape (50 x 50 to 4 x 4 maps at 100 x 100;
  the 32 x 32 input reaches 1 x 1 maps, the 128 x 128 input 64 x 64 ones):
  the kernel's output equal to the program's PyTorch path (F.pad where the
  padding is uneven, then F.conv2d) bit for bit.  The shapes and inputs
  are chip_smoke.py's."""
  import chip_smoke  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.models import perception  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.ops import depthwise_cuda as dw  # pylint: disable=import-outside-toplevel
  shapes = chip_smoke.encoder_depthwise(size)
  assert len(shapes) == chip_smoke.DEPTHWISE_PER_FORWARD
  apart = []
  for i, shape in enumerate(shapes):
    x, weight = chip_smoke.depthwise_case(batch, shape, i)
    c, _, _, stride, padding = shape
    y = dw.depthwise(x, weight, stride, padding)
    if not torch.equal(y, perception.same_conv(x, weight, stride, padding,
                                               groups=c)):
      apart.append(shape)
  assert not apart


def test_encoder_forward_with_the_depthwise_kernel_equals_pytorch(card):
  """A whole MobileNetV2 forward with the kernel (17 launches) against the
  same forward with the depthwise layers on PyTorch's path."""
  from oatomobile_torch.models import MobileNetV2  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.ops import depthwise_cuda as dw  # pylint: disable=import-outside-toplevel
  g = torch.Generator(device=card).manual_seed(3)
  model = MobileNetV2(device=card).requires_grad_(False)
  x = torch.rand(256, 2, 100, 100, generator=g, device=card)
  before = dw.KERNEL.launches
  with torch.no_grad():
    got = model(x)
  assert dw.KERNEL.launches == before + 17
  with pytest.MonkeyPatch.context() as mp, torch.no_grad():
    mp.setattr(dw, "engages", lambda h: False)
    want = model(x)
  assert dw.KERNEL.launches == before + 17
  assert torch.equal(got, want)


def test_depthwise_graph_replay_matches_eager_call(card):
  import chip_smoke  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.ops import depthwise_cuda as dw  # pylint: disable=import-outside-toplevel
  shape = (96, 50, 50, 2, (0, 1, 0, 1))
  x, weight = chip_smoke.depthwise_case(64, shape, 1)
  dw.depthwise(x, weight, 2, shape[4])
  torch.cuda.synchronize()
  graph = torch.cuda.CUDAGraph()
  with torch.cuda.graph(graph):
    captured = dw.depthwise(x, weight, 2, shape[4])
  x.copy_(chip_smoke.depthwise_case(64, shape, 2)[0])
  graph.replay()
  eager = dw.depthwise(x, weight, 2, shape[4])
  torch.cuda.synchronize()
  assert torch.equal(captured, eager)


def test_depthwise_launches_only_without_autograd(card):
  from oatomobile_torch.baselines.learned.dim.policy import encoder_copy  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.models import ImitativeModel  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.ops import depthwise_cuda as dw  # pylint: disable=import-outside-toplevel
  model = ImitativeModel(device=card).requires_grad_(False)
  x = torch.rand(4, 2, 100, 100, device=card)
  before = dw.KERNEL.launches
  with torch.no_grad():
    model.encoder(x)
  assert dw.KERNEL.launches == before + 17
  model.encoder(x)  # autograd on: the plain path
  with torch.no_grad():
    encoder_copy(model, "bfloat16").encoder(x.to(torch.bfloat16))
  assert dw.KERNEL.launches == before + 17
  with torch.no_grad():  # 64 x 64 maps: planes past the tile, in bands
    model.encoder(torch.rand(2, 2, 160, 160, device=card))
  assert dw.KERNEL.launches == before + 34


def test_depthwise_kernel_refuses_what_it_does_not_take(card):
  from oatomobile_torch.ops import depthwise_cuda as dw  # pylint: disable=import-outside-toplevel
  x = torch.randn(2, 16, 5, 5, device=card)
  w = torch.randn(16, 1, 3, 3, device=card)
  pad = (1, 1, 1, 1)
  before = dw.KERNEL.launches
  with pytest.raises(ValueError):
    dw.depthwise(x.transpose(2, 3), w, 1, pad)
  with pytest.raises(ValueError):
    dw.depthwise(x, torch.randn(16, 1, 5, 5, device=card), 1, pad)
  with pytest.raises(TypeError):
    dw.depthwise(x.double(), w, 1, pad)
  with pytest.raises(ValueError):
    dw.depthwise(x, w.cpu(), 1, pad)
  with pytest.raises(ValueError):
    dw.depthwise(x, w, 3, pad)
  assert dw.KERNEL.launches == before
  # The entry point refuses a padding of 3.
  y = torch.empty(2, 16, 9, 9, device=card)
  err = dw.KERNEL.library().depthwise_conv_launch(
      x.data_ptr(), w.data_ptr(), y.data_ptr(), 32, 16, 5, 5, 5, 5, 1, 3, 1,
      torch.cuda.current_stream().cuda_stream)
  assert err != 0


# -- TransFuser's fusion upsample-and-add kernel -------------------------------


@pytest.mark.parametrize("batch", [256, 1])
def test_fusion_upsample_kernel_equals_pytorch_at_every_fusion_shape(
    card, batch):
  """Each of the four fusions' shapes (C = 64, 128, 256, 512 at 64, 32,
  16, 8 pixels), both trunks: the kernel's sums equal to PyTorch's ``trunk
  + F.interpolate(anchors, scale_factor=scale, mode="bilinear",
  align_corners=False)`` bit for bit.  The shapes and inputs are
  chip_smoke.py's."""
  import chip_smoke  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.ops import fusion_upsample_cuda as fu  # pylint: disable=import-outside-toplevel
  apart = []
  for i, (c, s) in enumerate(chip_smoke.FUSIONS):
    trunks, anchors = chip_smoke.fusion_case(batch, c, s, i)
    got = fu.upsample_add(trunks, anchors, s)
    want = chip_smoke.fusion_library(trunks, anchors, s)
    apart += [(c, s, side) for side in (0, 1)
              if not torch.equal(got[side], want[side])]
  assert not apart


def test_transfuser_encode_launches_the_fusion_kernel_four_times(card):
  """One TransFuser encode under no_grad: 4 launches, z equal to the same
  encode on PyTorch's path bit for bit; with autograd on, none."""
  from oatomobile_torch.models.transfuser import TransFuser  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.ops import fusion_upsample_cuda as fu  # pylint: disable=import-outside-toplevel
  g = torch.Generator(device=card).manual_seed(3)
  model = TransFuser(device=card).eval().requires_grad_(False)
  inputs = (torch.randn(8, 3, 256, 256, generator=g, device=card),
            torch.rand(8, 2, 256, 256, generator=g, device=card),
            8 * torch.rand(8, generator=g, device=card))
  before = fu.KERNEL.launches
  with torch.no_grad():
    got = model.encode(*inputs)
  assert fu.KERNEL.launches == before + 4
  with pytest.MonkeyPatch.context() as mp, torch.no_grad():
    mp.setattr(fu, "engages", lambda x: False)
    want = model.encode(*inputs)
  assert torch.equal(got, want)
  model.encode(*inputs)  # autograd on: PyTorch's path
  assert fu.KERNEL.launches == before + 4


def test_fusion_upsample_graph_replay_matches_eager_call(card):
  import chip_smoke  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.ops import fusion_upsample_cuda as fu  # pylint: disable=import-outside-toplevel
  trunks, anchors = chip_smoke.fusion_case(16, 128, 4, 1)
  fu.upsample_add(trunks, anchors, 4)
  torch.cuda.synchronize()
  graph = torch.cuda.CUDAGraph()
  with torch.cuda.graph(graph):
    captured = fu.upsample_add(trunks, anchors, 4)
  fresh = chip_smoke.fusion_case(16, 128, 4, 2)
  for static, new in zip(trunks + anchors, fresh[0] + fresh[1]):
    static.copy_(new)
  graph.replay()
  eager = fu.upsample_add(*fresh, 4)
  torch.cuda.synchronize()
  assert all(torch.equal(a, b) for a, b in zip(captured, eager))


def test_fusion_upsample_kernel_refuses_what_it_does_not_take(card):
  from oatomobile_torch.ops import fusion_upsample_cuda as fu  # pylint: disable=import-outside-toplevel
  trunks = tuple(torch.randn(2, 16, 16, 16, device=card) for _ in range(2))
  anchors = tuple(torch.randn(2, 16, 8, 8, device=card) for _ in range(2))
  before = fu.KERNEL.launches
  with pytest.raises(TypeError):
    fu.upsample_add((trunks[0].double(), trunks[1]), anchors, 2)
  with pytest.raises(ValueError):
    fu.upsample_add(trunks, (anchors[0].cpu(), anchors[1]), 2)
  with pytest.raises(ValueError):
    fu.upsample_add(trunks, anchors, 4)
  misaligned = torch.randn(2 * 16 * 16 * 16 + 1, device=card)[1:].view(
      2, 16, 16, 16)
  with pytest.raises(ValueError, match="aligned"):
    fu.upsample_add((misaligned, trunks[1]), anchors, 2)
  assert fu.KERNEL.launches == before
  # The entry point refuses a scale past 128.
  err = fu.KERNEL.library().fusion_upsample_launch(
      trunks[0].data_ptr(), anchors[0].data_ptr(), trunks[0].data_ptr(),
      trunks[1].data_ptr(), anchors[1].data_ptr(), trunks[1].data_ptr(),
      32, 129, torch.cuda.current_stream().cuda_stream)
  assert err != 0
