"""Closed-loop rollout cells of the RIP ensemble: ``BatchedEnv.rollout``
chunks issued back to back by one client, each ended by a host fetch of
its episode stats, as ``rollout`` runs the DIM cell, with K DIM members
in the policy.

The program's policy is built only by ``make_rip_policy`` and called only
through ``env.rollout(policy=)``.  Set-up builds the scene batch, draws
each member's weights from the seed (``member_seed``) and warms the
cell's own shapes with a few chunks (the eager warm-up steps and the
CUDA-graph capture).  The window issues chunks for ``seconds``.  After
it: with ``trace``, a profiled run of captured chunks; then the check,
once the program's state is freed: the reference builds the scene batch
from the seed (compared whole with the program's initial state) and
follows a sample of the window's chunks, drawn from the seed, from the
program's state before each, with the reference's RIP policy over the
same weights.
"""

import gc
import math
import statistics
import time
from typing import Dict, List, Optional

import torch

from perfbench import check as check_lib
from perfbench import link
from perfbench import marks as marks_lib
from perfbench import trace as trace_lib
from perfbench import weights as weights_lib
from perfbench.counts import rip_flops
from perfbench.drivers.rollout import (LINK_WARM_S, WARM_STEPS, _host,
                                       _sample, env_seed, tenths)
from perfbench.reference import rollout as ref_rollout
from perfbench.report import Result

# The marks of a replayed step, in the order the step runs them.
STEP_MARKS = ("rip.observe", "rip.encode", "rip.plan", "rip.act",
              "world_step", "sensors", "bookkeeping")


def member_seed(seed: int, member: int, members: int) -> int:
  """The seed of member ``member``'s weights: distinct over members and
  over runs."""
  return members * int(seed) + member


def _weights(config, seed: int, device) -> List[Dict[str, torch.Tensor]]:
  from perfbench.reference.models.dim import ImitativeModel  # pylint: disable=import-outside-toplevel
  shape = ImitativeModel(tuple(config["output_shape"]),
                         tuple(config["input_size"]), device="meta")
  k = int(config["members"])
  return [weights_lib.draw(shape, member_seed(seed, i, k), device)
          for i in range(k)]


def _policy(config, weights, device, reference: bool):
  """The RIP policy over the members' ``weights``: the program's, or the
  reference's."""
  kwargs = dict(algorithm=config["algorithm"],
                num_plan_steps=config["num_plan_steps"],
                lr=config["plan_lr"], epsilon=config["plan_epsilon"])
  shape, size = tuple(config["output_shape"]), tuple(config["input_size"])
  if reference:
    from perfbench.reference.models.dim import ImitativeModel  # pylint: disable=import-outside-toplevel
    from perfbench.reference.policy.rip_policy import RipPolicy  # pylint: disable=import-outside-toplevel
    return RipPolicy([weights_lib.load(ImitativeModel(shape, size,
                                                      device="meta"),
                                       w, device) for w in weights],
                     **kwargs)
  from oatomobile_torch.baselines.learned.rip.policy import make_rip_policy  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.models import ImitativeModel  # pylint: disable=import-outside-toplevel
  return make_rip_policy([weights_lib.load(ImitativeModel(shape, size,
                                                          device="meta"),
                                           w, device) for w in weights],
                         **kwargs)


def step_marks_ms() -> Dict[str, Optional[float]]:
  """Median device ms a replayed step of the step runner
  (``rollout.issue``) and of each of the step's marks (a mark's ms
  whole, whatever its count), where the program records them."""
  out = {"rollout.issue": marks_lib.median_ms("rollout.issue", "replay")}
  for name in STEP_MARKS:
    found = marks_lib.samples(name, "replay")
    if found:
      out[name] = statistics.median(s.ms for s in found)
  return out


def run(cell, *, seed: int, seconds: float, trace: bool, control: bool,
        device, process_start: float, overrides=None) -> Result:
  """One run of a RIP rollout cell (``overrides`` replaces traffic keys:
  the tests run the cell at a small size on the CPU)."""
  from oatomobile_torch.envs.batched import BatchedEnv  # pylint: disable=import-outside-toplevel
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

  weights = _weights(config, seed, device)
  policy = _policy(config, weights, device, reference=False)

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
      "env_build_s": env_build_s, "capture_s": capture_s,
      "step_marks_ms": step_marks_ms(),
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
    result.context = {
        "host": {"env_build_s": env_build_s, "capture_s": capture_s},
        "step_ms": 1e3 * window_s / steps, "replay": replay,
        "replay_steps": trace_chunks * chunk,
        "step_flops": rip_flops.closed_loop_step_flops(config, scenes),
    }
    result.device.update(busy_s=replay.busy_us() / 1e6,
                         window_s=replay.seconds)
    result.breakdown = {"device_ops": replay.top_ops(),
                        "idle_gaps": replay.idle_gaps()}

  # --- the check -----------------------------------------------------------------
  kept = {i: (_host(ref_rollout.leaves(b)), _host(ref_rollout.leaves(a)), s)
          for i, (b, a, s) in kept.items()}
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
  the reference's RIP steps from each kept chunk's state before against
  the program's state and stats after (with ``control``, the reference
  with TF32 on stands in for the program)."""
  ref = ref_rollout.ReferenceEnv(
      traffic["town"], int(traffic["scenes"]),
      num_vehicles=traffic["vehicles"],
      num_pedestrians=traffic.get("pedestrians", 0),
      max_episode_steps=traffic["max_episode_steps"],
      route_capacity=traffic["route_capacity"], seed=env_seed(seed),
      device=device)
  init_bad = check_lib.mismatches(initial,
                                  _host(ref_rollout.leaves(ref.initial)))
  policy = _policy(config, weights, device, reference=True)
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
