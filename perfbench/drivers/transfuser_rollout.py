"""Closed-loop rollout cells of TransFuser: ``BatchedEnv.rollout`` chunks
issued back to back by one client, each ended by a host fetch of its
episode stats, as ``rip_rollout`` runs the RIP cell, with the camera +
LiDAR fusion transformer as the policy.

The program's policy is built only by ``make_transfuser_policy`` and
called only through ``env.rollout(policy=)``.  Set-up builds the scene
batch, draws the weights from the seed (``draw_weights``), sets every
BatchNorm's running statistics from one forward of the reference's model
over the program's observation of the initial scenes (``calibrate``),
and warms the cell's own shapes with a few chunks (the eager warm-up
steps and the CUDA-graph capture).  The window issues chunks for
``seconds``.  After it: with ``trace``, a profiled run of captured
chunks; the program's plans of the sampled chunks' first states
(``policy.encode`` and ``decode``, eagerly); then the check, once the
program's state is freed: the reference builds the scene batch from the
seed (compared whole with the program's initial state) and follows a
sample of the window's chunks, drawn from the seed, from the program's
state before each, with the reference's TransFuser policy over the same
weights; ``plan_gap`` compares the plans of those states.
"""

import contextlib
import gc
import math
import statistics
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch

from perfbench import check as check_lib
from perfbench import link
from perfbench import marks as marks_lib
from perfbench import trace as trace_lib
from perfbench import weights as weights_lib
from perfbench.counts import splat as splat_counts
from perfbench.counts import transfuser_flops
from perfbench.drivers.rollout import (LINK_WARM_S, WARM_STEPS, _host,
                                       _sample, env_seed, tenths)
from perfbench.reference import rollout as ref_rollout
from perfbench.report import Result

# The marks of a replayed step, in the order the step runs them.
STEP_MARKS = ("transfuser.observe", "transfuser.encode",
              "transfuser.decode", "transfuser.act", "world_step",
              "sensors", "bookkeeping")
# Marks that recur within one step (once a stage): summed over the step.
STAGE_MARKS = ("transfuser.trunk", "transfuser.fuse")

# Standard deviation of a unit normal clipped to [-2, 2].
_CLIPPED_STD = 0.87962566103423978
# The source's initial scale of its transformers' Linear layers.
GPT_STD = 0.02


def _scales(model: torch.nn.Module) -> Dict[str, float]:
  """name -> standard deviation of every parameter drawn at random; 0.0
  for a zero, -1.0 for a one.  Convolutions: He's normal over the fan-out
  (torchvision's ResNet); the transformers' Linear layers and position
  embeddings: 0.02 (the source's GPT); the join, GRU and output layers:
  1 / sqrt(fan-in) (the GRU: 1 / sqrt(hidden), PyTorch's bound); biases 0;
  BatchNorm and LayerNorm scales 1."""
  out = {}
  for prefix, m in model.named_modules():
    name = (prefix + ".") if prefix else ""
    own = dict(m.named_parameters(recurse=False))
    if not own:
      continue
    gpt = ".transformer" in "." + prefix
    if isinstance(m, torch.nn.Conv2d):
      kh, kw = m.kernel_size
      out[name + "weight"] = math.sqrt(2.0 / (m.out_channels * kh * kw))
    elif isinstance(m, torch.nn.Linear):
      out[name + "weight"] = (GPT_STD if gpt else
                              1.0 / math.sqrt(m.in_features))
      out[name + "bias"] = 0.0
    elif isinstance(m, (torch.nn.BatchNorm2d, torch.nn.LayerNorm)):
      out[name + "weight"] = -1.0
      out[name + "bias"] = 0.0
    elif isinstance(m, torch.nn.GRUCell):
      out[name + "weight_ih"] = 1.0 / math.sqrt(m.hidden_size)
      out[name + "weight_hh"] = 1.0 / math.sqrt(m.hidden_size)
      out[name + "bias_ih"] = 0.0
      out[name + "bias_hh"] = 0.0
    elif set(own) == {"pos_emb"}:
      out[name + "pos_emb"] = GPT_STD
    else:
      raise ValueError("no initial distribution for {} ({})".format(
          prefix, type(m).__name__))
    missing = {name + k for k in own} - set(out)
    if missing:
      raise ValueError("no initial distribution for {}".format(missing))
  return out


def draw_weights(seed: int, device) -> Dict[str, torch.Tensor]:
  """The state dict (parameters and BatchNorm buffers) of the reference's
  TransFuser drawn from ``seed`` on ``device``, in one draw: normals
  clipped to two standard deviations and scaled to keep their variance
  (``_scales``); running means 0, variances 1 (see ``calibrate``)."""
  from perfbench.reference.models.transfuser import TransFuser  # pylint: disable=import-outside-toplevel
  device = torch.device(device)
  shape = TransFuser(device="meta")
  scales = _scales(shape)
  state = shape.state_dict()
  drawn = [n for n, s in scales.items() if s > 0]
  sizes = [state[n].numel() for n in drawn]
  gen = torch.Generator(device=device)
  gen.manual_seed(int(seed) % (2**63))
  flat = torch.randn(sum(sizes), generator=gen, device=device,
                     dtype=torch.float32).clamp_(-2.0, 2.0)
  out = {}
  for n, part in zip(drawn, torch.split(flat, sizes)):
    out[n] = (part * (scales[n] / _CLIPPED_STD)).reshape(state[n].shape)
  for n, value in state.items():
    if n in out:
      continue
    if n.endswith("running_var") or scales.get(n) == -1.0:
      out[n] = torch.ones(value.shape, device=device)
    elif n.endswith("num_batches_tracked"):
      out[n] = torch.zeros((), dtype=torch.long, device=device)
    else:
      out[n] = torch.zeros(value.shape, device=device)
  return out


def _reference_model(weights, device):
  from perfbench.reference.models.transfuser import TransFuser  # pylint: disable=import-outside-toplevel
  return weights_lib.load(TransFuser(device="meta"), weights, device)


def calibrate(weights: Dict[str, torch.Tensor], image: torch.Tensor,
              lidar: torch.Tensor, speed: torch.Tensor,
              target_point: torch.Tensor) -> Dict[str, torch.Tensor]:
  """``weights`` with every BatchNorm's running mean and variance set to
  the statistics of its input in one forward of the reference's model
  over the batch, each BatchNorm normalising with its batch's statistics
  in that forward: every stage's activations then stay of order one in
  eval mode (with running statistics 0 and 1 the residual sums grow about
  two-fold a block)."""
  model = _reference_model(weights, image.device)
  for m in model.modules():
    if isinstance(m, torch.nn.BatchNorm2d):
      m.reset_running_stats()
      m.momentum = None  # the running statistics of one batch are its own
  model.train()
  with torch.no_grad():
    model(image, lidar, speed, target_point)
  out = dict(weights)
  out.update({k: v.detach().clone() for k, v in model.state_dict().items()
              if "running_" in k or k.endswith("num_batches_tracked")})
  return out


def _weights(seed: int, env, device) -> Dict[str, torch.Tensor]:
  """The cell's weights: drawn from the seed, calibrated on the program's
  observation of the scene batch's initial state."""
  from oatomobile_torch.baselines.learned.transfuser import policy as tf_policy  # pylint: disable=import-outside-toplevel
  weights = draw_weights(seed, device)
  obs = tf_policy.observe(env.params, env.state)
  return calibrate(weights, obs.image, obs.lidar, obs.speed,
                   obs.target_point)


def _policy(weights, device, reference: bool):
  """The TransFuser policy over ``weights``: the program's, or the
  reference's."""
  if reference:
    from perfbench.reference.policy.transfuser_policy import TransFuserPolicy  # pylint: disable=import-outside-toplevel
    return TransFuserPolicy(_reference_model(weights, device))
  from oatomobile_torch.baselines.learned.transfuser import make_transfuser_policy  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.models.transfuser import TransFuser  # pylint: disable=import-outside-toplevel
  return make_transfuser_policy(
      weights_lib.load(TransFuser(device="meta"), weights, device))


def _program_plan(policy, params, state) -> torch.Tensor:
  """The program's plan of ``state`` through its policy's stages."""
  obs = policy.observe(params, state)
  return policy.decode(policy.encode(obs), obs)


@contextlib.contextmanager
def _tf32():
  """TF32 on for matrix products and convolutions, as the reference's
  ``"tf32"`` precision."""
  flags = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
  torch.backends.cuda.matmul.allow_tf32 = True
  torch.backends.cudnn.allow_tf32 = True
  try:
    yield
  finally:
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = flags


def stage_sums_ms(name: str) -> List[float]:
  """The device ms of a mark that recurs within a step, summed over each
  replayed step that recorded it (a rollout call's last replay)."""
  by_step = defaultdict(float)
  for s in marks_lib.samples(name, "replay"):
    by_step[s.index] += s.ms
  return list(by_step.values())


def step_marks_ms() -> Dict[str, Optional[float]]:
  """Median device ms a replayed step of the step runner
  (``rollout.issue``), of each of the step's marks (a mark's ms whole,
  whatever its count) and of each recurring mark summed over the step,
  where the program records them."""
  out = {"rollout.issue": marks_lib.median_ms("rollout.issue", "replay")}
  for name in STEP_MARKS:
    found = marks_lib.samples(name, "replay")
    if found:
      out[name] = statistics.median(s.ms for s in found)
  for name in STAGE_MARKS:
    sums = stage_sums_ms(name)
    if sums:
      out[name] = statistics.median(sums)
  return out


def run(cell, *, seed: int, seconds: float, trace: bool, control: bool,
        device, process_start: float, overrides=None) -> Result:
  """One run of a TransFuser rollout cell (``overrides`` replaces traffic
  keys: the tests run the cell at a small size on the CPU)."""
  from oatomobile_torch.envs.batched import BatchedEnv  # pylint: disable=import-outside-toplevel
  import oatomobile_torch.baselines.learned.transfuser  # pylint: disable=import-outside-toplevel,unused-import
  traffic = dict(cell["traffic"], **(overrides or {}))
  config = cell["config"]
  cuda = torch.device(device).type == "cuda"
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  scenes, chunk = int(traffic["scenes"]), int(traffic["chunk_steps"])
  compute = tuple(traffic["compute"])

  # --- set-up ----------------------------------------------------------------
  t0 = time.perf_counter()
  env = BatchedEnv(traffic["town"], scenes,
                   num_vehicles=traffic["vehicles"],
                   num_pedestrians=traffic.get("pedestrians", 0),
                   max_episode_steps=traffic["max_episode_steps"],
                   route_capacity=traffic["route_capacity"],
                   seed=env_seed(seed), device=device)
  initial = _host(ref_rollout.leaves(env.state))
  if cuda:
    torch.cuda.synchronize()
  env_build_s = time.perf_counter() - t0

  t0 = time.perf_counter()
  weights = _weights(seed, env, device)
  policy = _policy(weights, device, reference=False)
  if cuda:
    torch.cuda.synchronize()
  weights_s = time.perf_counter() - t0

  def issue():
    final, _, stats = env.rollout(chunk, policy=policy, compute=compute)
    return final, _host(stats)

  t0 = time.perf_counter()
  for _ in range(math.ceil(WARM_STEPS / chunk) + 1):
    last_final, _ = issue()
  capture_s = time.perf_counter() - t0

  setup_peak = link.warm(LINK_WARM_S, device)

  # --- the window ------------------------------------------------------------
  sample = set(_sample(seed, traffic["check_chunks"],
                       traffic["check_within"]))
  kept: Dict[int, tuple] = {}
  latencies = []
  start = time.perf_counter()
  setup_s = start - process_start
  now = start
  k = 0
  while now - start < seconds:
    before = last_final
    t = time.perf_counter()
    last_final, stats = issue()
    now = time.perf_counter()
    latencies.append(now - t)
    if k in sample:
      kept[k] = (before, last_final, stats)
    last_pair = (before, last_final, stats)
    k += 1
  window_s = now - start
  kept[k - 1] = last_pair
  peak = max(setup_peak, torch.cuda.max_memory_allocated() if cuda else 0)
  steps = k * chunk

  result = Result(attempted=k)
  result.end_to_end = {
      "env_steps_per_s": scenes * steps / window_s,
      "setup_s": setup_s,
  }
  result.notes = {
      "chunks": k, "window_s": window_s, "steps": steps,
      "chunk_ms_median": 1e3 * statistics.median(latencies),
      "chunk_ms_by_tenth": tenths(latencies),
      "env_build_s": env_build_s, "weights_s": weights_s,
      "capture_s": capture_s, "step_marks_ms": step_marks_ms(),
  }
  result.device = {"count": 1, "memory_peak_bytes": int(peak)}

  # --- the traced pass ---------------------------------------------------------
  if trace:
    trace_chunks = max(1, int(traffic["trace_steps"]) // chunk)

    def replays():
      for _ in range(trace_chunks):
        with trace_lib.span("chunk.rollout"):
          _, _, stats = env.rollout(chunk, policy=policy, compute=compute)
        with trace_lib.span("chunk.fetch"):
          _host(stats)

    replay = trace_lib.profile(replays)
    from oatomobile_torch.ops import bev  # pylint: disable=import-outside-toplevel
    splat_bound = splat_counts.bound_ms_of_inputs(
        *bev.gather_inputs(env.params, env.state))[0]
    result.context = {
        "host": {"env_build_s": env_build_s, "capture_s": capture_s},
        "step_ms": 1e3 * window_s / steps, "replay": replay,
        "replay_steps": trace_chunks * chunk,
        "splat_bound_ms": splat_bound,
        "step_flops": transfuser_flops.closed_loop_step_flops(config,
                                                             scenes),
    }
    result.device.update(busy_s=replay.busy_us() / 1e6,
                         window_s=replay.seconds)
    result.breakdown = {"device_ops": replay.top_ops(),
                        "idle_gaps": replay.idle_gaps()}

  # --- the check -----------------------------------------------------------------
  plans = {i: _program_plan(policy, env.params, b).cpu()
           for i, (b, _, _) in kept.items()}
  kept = {i: (_host(ref_rollout.leaves(b)), _host(ref_rollout.leaves(a)), s)
          for i, (b, a, s) in kept.items()}
  del env, policy, last_final, last_pair, before
  gc.collect()
  if cuda:
    torch.cuda.empty_cache()
  t0 = time.perf_counter()
  result.checks, gaps = compare(config, traffic, seed, weights, initial,
                                kept, plans, control, device)
  result.notes.update(gaps, check_s=time.perf_counter() - t0,
                      checked_chunks=sorted(kept))
  return result


def compare(config, traffic, seed, weights, initial, kept, plans, control,
            device):
  """(checks, notes): the reference's scene batch against the program's
  initial state, and the reference's TransFuser steps from each kept
  chunk's state before against the program's state and stats after; the
  notes give the reference's plan of each of those states against the
  program's (``plan_gap``: the largest difference over the largest
  waypoint coordinate, 0 where bit-equal) and that largest coordinate.
  With ``control``, the reference with TF32 on stands in for the
  program."""
  from perfbench.reference.policy import transfuser_policy as ref_policy  # pylint: disable=import-outside-toplevel
  ref = ref_rollout.ReferenceEnv(
      traffic["town"], int(traffic["scenes"]),
      num_vehicles=traffic["vehicles"],
      num_pedestrians=traffic.get("pedestrians", 0),
      max_episode_steps=traffic["max_episode_steps"],
      route_capacity=traffic["route_capacity"], seed=env_seed(seed),
      device=device)
  init_bad = check_lib.mismatches(initial,
                                  _host(ref_rollout.leaves(ref.initial)))
  policy = _policy(weights, device, reference=True)
  chunk, compute = int(traffic["chunk_steps"]), tuple(traffic["compute"])
  gap = plan_gap = plan_max = 0.0
  for i in sorted(kept):
    before, after, stats = kept[i]
    start = ref_rollout.state_from_leaves(
        {k: v.to(device) for k, v in before.items()})
    want_state, want_stats = ref.rollout(start, chunk, policy, compute)
    want = dict(ref_rollout.leaves(want_state),
                **{"stats." + k: v for k, v in want_stats.items()})
    obs = ref_policy.observe(ref.params, start)
    want_plan = policy.plan(obs).cpu()
    if control:
      got_state, got_stats = ref.rollout(start, chunk, policy, compute,
                                         precision=config["control"])
      got = dict(ref_rollout.leaves(got_state),
                 **{"stats." + k: v for k, v in got_stats.items()})
      with _tf32():
        got_plan = policy.plan(obs).cpu()
    else:
      got = dict(after, **{"stats." + k: v for k, v in stats.items()})
      got_plan = plans[i]
    gap = max(gap, check_lib.state_gap(got, want))
    plan_max = max(plan_max, float(want_plan.abs().max()))
    plan_gap = max(plan_gap, float((got_plan - want_plan).abs().max()) /
                   max(float(want_plan.abs().max()), 1e-30))
  limits = traffic["limits"]
  checks = [check_lib.Check("init_mismatch", init_bad,
                            limits["init_mismatch"]),
            check_lib.Check("state_gap", gap, limits["state_gap"])]
  return checks, {"plan_gap": plan_gap, "plan_abs_max_m": plan_max}
