"""Closed-loop rollout cells: ``BatchedEnv.rollout`` chunks issued back to
back by one client, each ended by a host fetch of its episode stats (as
the evaluators read them).

Set-up builds the scene batch and the policy, then warms the cell's own
shapes with a few chunks (the program's eager warm-up steps and its
CUDA-graph capture happen there).  The window issues chunks for
``seconds``.  After it: with ``trace``, a profiled run of captured chunks
and a profiled eager pass with the benchmark's spans around each layer;
then the check, once the program's state is freed: the reference builds
the scene batch from the seed itself (compared whole with the program's
initial state) and follows a sample of the window's chunks, drawn from the
seed, from the program's state before each.
"""

import gc
import math
import statistics
import time
from typing import Dict, List

import numpy as np
import torch

from perfbench import check as check_lib
from perfbench import link
from perfbench import trace as trace_lib
from perfbench import weights as weights_lib
from perfbench.counts import dim_flops, splat as splat_counts
from perfbench.reference import rollout as ref_rollout
from perfbench.report import Result

# Steps that warm the program's step before the window: its eager warm-up
# steps and the capture come within them.
WARM_STEPS = 4
# Host seconds of host-card copies enqueued after the warm-up
# (``link.py``).
LINK_WARM_S = 2.0


def percentile(values: List[float], q: int) -> float:
  """The q-th percentile, linear between order statistics (Python's
  ``statistics.quantiles`` with the inclusive method)."""
  if len(values) == 1:
    return values[0]
  return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def tenths(latencies: List[float]) -> List[float]:
  """The median ms of each tenth of the window's chunks, in order: how the
  latency moved through the window."""
  n = len(latencies)
  return [1e3 * statistics.median(latencies[i * n // 10:(i + 1) * n // 10]
                                  or latencies) for i in range(10)]


def env_seed(seed: int) -> int:
  """The scene batch's seed: numpy's legacy generator takes seeds below
  2^32; the run's seed may be larger."""
  return int(seed) % (2**31)


def _host(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
  return {k: v.cpu() for k, v in tree.items()}


def _dim_policy(config, weights, device, reference: bool):
  """The DIM policy over ``weights``: the program's, or the reference's."""
  kwargs = dict(num_plan_steps=config["num_plan_steps"],
                lr=config["plan_lr"], epsilon=config["plan_epsilon"])
  shape, size = tuple(config["output_shape"]), tuple(config["input_size"])
  if reference:
    from perfbench.reference.models.dim import ImitativeModel  # pylint: disable=import-outside-toplevel
    from perfbench.reference.policy.dim_policy import DimPolicy  # pylint: disable=import-outside-toplevel
    model = weights_lib.load(ImitativeModel(shape, size, device="meta"),
                             weights, device)
    return DimPolicy(model, **kwargs)
  from oatomobile_torch.baselines.learned.dim.policy import make_dim_policy  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.models import ImitativeModel  # pylint: disable=import-outside-toplevel
  model = weights_lib.load(ImitativeModel(shape, size, device="meta"),
                           weights, device)
  return make_dim_policy(model, **kwargs)


def _dim_weights(config, seed: int, device):
  from perfbench.reference.models.dim import ImitativeModel  # pylint: disable=import-outside-toplevel
  shape = ImitativeModel(tuple(config["output_shape"]),
                         tuple(config["input_size"]), device="meta")
  return weights_lib.draw(shape, seed, device)


def _sample(seed: int, count: int, within: int) -> List[int]:
  """Chunk indices to check, drawn from the seed among the first
  ``within`` chunks of the window (the last chunk is always checked)."""
  rs = np.random.RandomState(env_seed(seed) + 1)
  return sorted(rs.choice(within, size=min(count, within),
                          replace=False).tolist())


def _eager_layers(env, policy, compute, steps: int):
  """``steps`` eager steps from a copy of the live state, each layer of
  the program called inside a span of the benchmark's that ends with a
  synchronise (``trace.span``); the state is a copy, the env untouched."""
  from oatomobile_torch.ops import bev, bev_cuda  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.sim import autopilot_policy, world_step  # pylint: disable=import-outside-toplevel
  params, state = env.params, env.state
  span = trace_lib.span
  for _ in range(steps):
    if policy is None:
      with span("autopilot", sync=True):
        actions, state = autopilot_policy(params, state, noise=0.0)
    else:
      with span("dim.observe", sync=True):
        obs = policy.observe(params, state)
      with span("dim.encode", sync=True):
        z = policy.encode(obs)
      with span("dim.plan", sync=True):
        plan = policy.plan(z, obs)
      with span("dim.act", sync=True):
        actions, state = policy.act(params, state, plan, obs)
    with span("world_step", sync=True):
      state = world_step(params, state, actions)
    if "lidar" in compute:
      with span("bev.gather", sync=True):
        inputs = bev.gather_inputs(params, state)
      with span("bev.splat", sync=True):
        bev_cuda.splat_lidar_batch(*inputs)


def run(cell, *, seed: int, seconds: float, trace: bool, control: bool,
        device, process_start: float, overrides=None) -> Result:
  """One run of a rollout cell (``overrides`` replaces traffic keys: the
  tests run the cells at a small size on the CPU)."""
  from oatomobile_torch.envs.batched import BatchedEnv  # pylint: disable=import-outside-toplevel
  traffic = dict(cell["traffic"], **(overrides or {}))
  config = cell["config"]
  cuda = torch.device(device).type == "cuda"
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  scenes, chunk = int(traffic["scenes"]), int(traffic["chunk_steps"])
  compute = tuple(traffic["compute"])

  def sync():
    if cuda:
      torch.cuda.synchronize()

  # --- set-up ----------------------------------------------------------------
  t0 = time.perf_counter()
  env = BatchedEnv(traffic["town"], scenes,
                   num_vehicles=traffic["vehicles"],
                   num_pedestrians=traffic.get("pedestrians", 0),
                   max_episode_steps=traffic["max_episode_steps"],
                   route_capacity=traffic["route_capacity"],
                   seed=env_seed(seed), device=device)
  initial = _host(ref_rollout.leaves(env.state))
  sync()
  env_build_s = time.perf_counter() - t0

  weights = policy = None
  if config["policy"] == "dim":
    weights = _dim_weights(config, seed, device)
    policy = _dim_policy(config, weights, device, reference=False)

  def issue():
    final, _, stats = env.rollout(chunk, policy=policy, compute=compute)
    return final, _host(stats)

  t0 = time.perf_counter()
  warm_chunks = math.ceil(WARM_STEPS / chunk) + 1
  for _ in range(warm_chunks):
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
      "chunk_ms_p95": 1e3 * percentile(latencies, 95),
      "setup_s": setup_s,
  }
  result.notes = {
      "chunks": k, "window_s": window_s, "steps": steps,
      "chunk_ms_median": 1e3 * statistics.median(latencies),
      "chunk_ms_by_tenth": tenths(latencies),
      "env_build_s": env_build_s, "capture_s": capture_s,
  }
  result.device = {"count": 1, "memory_peak_bytes": int(peak)}

  # --- the traced pass ---------------------------------------------------------
  if trace:
    step_ms = 1e3 * window_s / steps
    trace_chunks = max(1, int(traffic["trace_steps"]) // chunk)

    def replays():
      for _ in range(trace_chunks):
        with trace_lib.span("chunk.rollout"):
          _, _, stats = env.rollout(chunk, policy=policy, compute=compute)
        with trace_lib.span("chunk.fetch"):
          _host(stats)

    replay = trace_lib.profile(replays)
    eager_steps = int(traffic["eager_trace_steps"])
    eager = trace_lib.profile(
        lambda: _eager_layers(env, policy, compute, eager_steps))
    splat_bound = None
    if "lidar" in compute or policy is not None:
      from oatomobile_torch.ops import bev  # pylint: disable=import-outside-toplevel
      splat_bound = splat_counts.bound_ms_of_inputs(
          *bev.gather_inputs(env.params, env.state))[0]
    flops = (dim_flops.closed_loop_step_flops(config, scenes)
             if config["policy"] == "dim" else None)
    result.context = {
        "host": {"env_build_s": env_build_s, "capture_s": capture_s},
        "step_ms": step_ms, "replay": replay,
        "replay_steps": trace_chunks * chunk, "eager": eager,
        "eager_steps": eager_steps, "splat_bound_ms": splat_bound,
        "step_flops": flops,
    }
    result.device.update(busy_s=replay.busy_us() / 1e6,
                         window_s=replay.seconds)
    result.breakdown = {"device_ops": replay.top_ops(),
                        "idle_gaps": replay.idle_gaps()}

  # --- the check -----------------------------------------------------------------
  kept = {i: (ref_rollout.leaves(b), ref_rollout.leaves(a), s)
          for i, (b, a, s) in kept.items()}
  kept = {i: (_host(b), _host(a), s) for i, (b, a, s) in kept.items()}
  del env, policy, last_final, last_pair, before
  gc.collect()
  if cuda:
    torch.cuda.empty_cache()
  t0 = time.perf_counter()
  result.checks = compare(config, traffic, seed, weights, initial, kept,
                          control, device)
  result.notes.update(check_s=time.perf_counter() - t0,
                      checked_chunks=sorted(kept))
  return result


def compare(config, traffic, seed, weights, initial, kept, control,
            device) -> List[check_lib.Check]:
  """The reference's scene batch against the program's initial state, and
  the reference's steps from each kept chunk's state before against the
  program's state and stats after (with ``control``, the reference in the
  configuration's next lower precision stands in for the program)."""
  ref = ref_rollout.ReferenceEnv(
      traffic["town"], int(traffic["scenes"]),
      num_vehicles=traffic["vehicles"],
      num_pedestrians=traffic.get("pedestrians", 0),
      max_episode_steps=traffic["max_episode_steps"],
      route_capacity=traffic["route_capacity"], seed=env_seed(seed),
      device=device)
  init_bad = check_lib.mismatches(initial,
                                  _host(ref_rollout.leaves(ref.initial)))
  policy = (_dim_policy(config, weights, device, reference=True)
            if config["policy"] == "dim" else None)
  chunk, compute = int(traffic["chunk_steps"]), tuple(traffic["compute"])
  gap = 0.0
  for i in sorted(kept):
    before, after, stats = kept[i]
    start = ref_rollout.state_from_leaves(
        {k: v.to(device) for k, v in before.items()})
    want_state, want_stats = ref.rollout(start, chunk, policy, compute)
    want = dict(ref_rollout.leaves(want_state),
                **{"stats." + k: v for k, v in want_stats.items()})
    if control:
      got_state, got_stats = ref.rollout(start, chunk, policy, compute,
                                         precision=config["control"])
      got = dict(ref_rollout.leaves(got_state),
                 **{"stats." + k: v for k, v in got_stats.items()})
    else:
      got = dict(after, **{"stats." + k: v for k, v in stats.items()})
    gap = max(gap, check_lib.state_gap(got, want))
  limits = traffic["limits"]
  return [check_lib.Check("init_mismatch", init_bad,
                          limits["init_mismatch"]),
          check_lib.Check("state_gap", gap, limits["state_gap"])]
