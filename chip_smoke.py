#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``oatomobile_torch``).

    python3 chip_smoke.py [--prev-splat PATH ...]

Needs one CUDA card and the CUDA toolkit (nvcc).  It:

  1. prints the card's name and power limit (nvidia-smi);
  2. builds every kernel of the main path from the sources in this
     checkout (the BEV splat, csrc/bev_splat.cu) and prints the build time,
     what ptxas reports and the loops of the kernel's SASS (cuobjdump);
  3. holds each kernel against its plain PyTorch version on the card: on
     the inputs the main path gives it (Town01, 16 NPCs, after 20 autopilot
     steps) and on inputs that stress its culling
     (``bev_cuda.stress_inputs``), at 64 and 1024 scenes; no pixel may
     differ;
  4. captures one splat in a CUDA graph, replays it on new inputs copied
     into the captured buffers and holds the result against the eager call;
  5. runs a small rollout on the card and on the CPU and holds the episode
     stats against each other;
  6. drives the main path: ``BatchedEnv("Town01", 1024, num_vehicles=16,
     route_capacity=1024, seed=0).rollout(256, compute=("lidar",))`` once
     to warm up and once timed, with every kernel's launch count set to 0
     just before the timed run and read just after;
  7. times each kernel (CUDA events around back-to-back calls, median
     of 21 runs) beside its plain version and its bound, and a fill of a
     tensor the size of the splat's output (what the card's memory gives a
     write of those bytes);
  8. holds the learned DIM agent on the card against the CPU (Town02, 4
     scenes, 8 NPCs, weights from one seeded generator): one policy call
     on the same state (plan and actions within 1e-3), then a 10-step
     rollout on each (episodes and collisions equal, distance within
     1e-2 m); and its bfloat16 encoder against the float32 one;
  9. drives the DIM path: ``BatchedEnv("Town01", 1024, num_vehicles=16,
     route_capacity=1024, seed=0).rollout(DIM_STEPS, policy=DIM)`` with
     ``make_dim_policy(ImitativeModel((4, 2), (100, 100)),
     num_plan_steps=20)``, float32 encoder, ``compute=()``: a short warm-up
     rollout, then a timed one with the kernels' launch counts set to 0
     just before it and read just after (one splat a step), and the
     stages of one policy call (observe, encoder, planner, bridge) on CUDA
     events;
 10. prints one JSON line of the kernels and, last, the ok/device line.

``--prev-splat PATH`` (may be given more than once) names another design
of the splat, a bev_splat.cu with the same C entry point
``bev_splat_launch``: it is built the same way, checked against the plain
version on the main path's inputs, and timed in turn with this one (old,
new, new, old) at the main path's final inputs; the first one's time is
the kernels line's ``prev_ms``.

Any failure exits non-zero before the last line.  Without a CUDA device,
or outside a checkout of the repository, it exits 1 and prints no result.
"""

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time

STEPS = 256
BATCH = 1024
TOWN = "Town01"
VEHICLES = 16
# Steps of the timed DIM rollout (as the bench's) and of its warm-up.
DIM_STEPS = 256
DIM_WARMUP_STEPS = 4
# DIM on the card against the CPU: plan and actions of one call, and the
# distance of a 10-step rollout (metres).
DIM_CALL_ATOL = 1e-3
DIM_DISTANCE_ATOL = 1e-2

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM bandwidth and
# FP32 rate outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# FP32 operations per pixel-slot test of the splat: u and v are two
# products and two sums each, then two compares (|x| <= h, the abs being
# an operand modifier).
OPS_PER_TEST = 10
# Kernel against plain version: no pixel may differ.  The kernel rounds
# every product and sum as the plain version does (no FMA), and its
# culling boxes are conservative, so the two are equal bit for bit.


def fail(message: str) -> None:
  print("chip_smoke: FAILED: " + message, file=sys.stderr)
  sys.exit(1)


def card_line() -> str:
  out = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"], capture_output=True, text=True, check=True,
      timeout=60)
  return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, calls: int, reps: int = 21) -> float:
  """Milliseconds per call of ``fn()`` on the device: CUDA events around
  ``calls`` back-to-back calls, so the host's launch work overlaps the
  previous call's device work; the median over ``reps`` such runs."""
  import torch  # pylint: disable=import-outside-toplevel
  fn()
  torch.cuda.synchronize()
  times = []
  for _ in range(reps):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
      fn()
    end.record()
    end.synchronize()
    times.append(start.elapsed_time(end) / calls)
  return statistics.median(times)


def splat_bound_ms(hero, walls, roads, boxes):
  """Least time of the splat on an H100: bytes (inputs read once, output
  written once) over the memory rate, or the operations of the pixel-slot
  tests these inputs need (empty slots are skipped) over the FP32 rate."""
  B = hero.shape[0]
  tables = (200 + 2 * 200 * 200) * 4
  in_bytes = sum(x.numel() * 4 for x in (hero, walls, roads, boxes)) + tables
  out_bytes = B * 200 * 200 * 2 * 4
  live_slots = int(sum((x[..., 2] > 0).sum().item()
                       for x in (walls, roads, boxes)))
  ops = 200 * 200 * live_slots * OPS_PER_TEST
  bytes_ms = 1e3 * (in_bytes + out_bytes) / PEAK_BYTES_PER_S
  ops_ms = 1e3 * ops / PEAK_FP32_PER_S
  return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                 else "operations"), live_slots / B


def prev_splat(source: str, bev_cuda):
  """(name, library, launcher) of another design of the splat kernel built
  from ``source``, the launcher called like ``splat_lidar_batch``."""
  import torch  # pylint: disable=import-outside-toplevel
  name = os.path.splitext(os.path.basename(source))[0]
  library = os.path.join(os.path.dirname(bev_cuda.LIBRARY),
                         "libprev_{}.so".format(name))
  lib = ctypes.CDLL(bev_cuda.build(source, library))
  ptr, i32 = ctypes.c_void_p, ctypes.c_int
  lib.bev_splat_launch.argtypes = [ptr, ptr, i32, ptr, i32, ptr, i32, ptr,
                                   ptr, ptr, ptr, i32, ptr]
  lib.bev_splat_launch.restype = i32

  def launch(hero, walls, roads, boxes):
    centers, counts, ground = bev_cuda._tables(hero.device)  # pylint: disable=protected-access
    out = torch.empty((hero.shape[0], 200, 200, 2), dtype=torch.float32,
                      device=hero.device)
    err = lib.bev_splat_launch(
        hero.data_ptr(), walls.data_ptr(), walls.shape[1], roads.data_ptr(),
        roads.shape[1], boxes.data_ptr(), boxes.shape[1], centers.data_ptr(),
        counts.data_ptr(), ground.data_ptr(), out.data_ptr(), hero.shape[0],
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
      fail("{} failed to launch: CUDA error {}".format(source, err))
    return out

  return name, library, launch


def print_build(name: str, bev_cuda, library: str) -> None:
  """What ptxas said in the last build, and the loops of the SASS."""
  from oatomobile_torch import sass  # pylint: disable=import-outside-toplevel
  for line in bev_cuda.build_log.splitlines():
    if "registers" in line or "bytes stack" in line:
      print("ptxas {}: {}".format(name, line.strip()))
  try:
    lines = sass.report(library)
  except (RuntimeError, OSError, subprocess.CalledProcessError) as exc:
    lines = ["sass: not available ({})".format(exc)]
  for line in lines:
    print("{} {}".format(name, line))


def count_differing(out, ref) -> int:
  """Pixels of [B, 200, 200, 2] images where either channel differs (NaN
  differs from everything)."""
  return int((out != ref).any(-1).sum())


def check_dim_card_against_cpu() -> None:
  """One DIM policy call on the same Town02 state on the CPU and on the
  card, then a 10-step DIM rollout on each; fails beyond the limits."""
  import torch  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.baselines.learned.dim.policy import (  # pylint: disable=import-outside-toplevel
      encode, encoder_copy, make_dim_policy)
  from oatomobile_torch.envs.batched import BatchedEnv  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.models import ImitativeModel  # pylint: disable=import-outside-toplevel

  def model(device):
    return ImitativeModel((4, 2), (100, 100),
                          generator=torch.Generator().manual_seed(0),
                          device=device)

  env = BatchedEnv("Town02", 4, num_vehicles=8, seed=4, device="cpu")
  env.rollout(5)
  out = {}
  for device in ("cpu", "cuda"):
    params, state = env.params.to(device), env.state.to(device)
    policy = make_dim_policy(model(device))
    obs = policy.observe(params, state)
    z = policy.encode(obs)
    plan = policy.plan(z, obs)
    actions, _ = policy.act(params, state, plan, obs)
    z16 = encode(encoder_copy(policy.model, "bfloat16"), obs.context)
    out[device] = [x.cpu() for x in (z, plan, actions, z16)]
  (z_c, plan_c, act_c, _), (z_g, plan_g, act_g, z16_g) = out["cpu"], out["cuda"]
  errs = {name: float((a - b).abs().max()) for name, a, b in (
      ("z", z_c, z_g), ("plan", plan_c, plan_g), ("actions", act_c, act_g))}
  bf16_err = float((z16_g - z_g).abs().max())
  bf16_bound = 0.05 * max(float(z_g.abs().max()), 1.0)
  print("check dim policy call cuda vs cpu (Town02, 4 scenes, 8 NPCs): "
        "z_max_abs_diff={} plan_max_abs_diff={} actions_max_abs_diff={} "
        "(limit {}); bf16 encoder on the card: z_max_abs_diff={} (bound "
        "{})".format(errs["z"], errs["plan"], errs["actions"], DIM_CALL_ATOL,
                     bf16_err, bf16_bound))
  if errs["plan"] > DIM_CALL_ATOL or errs["actions"] > DIM_CALL_ATOL:
    fail("the DIM policy on the card disagrees with the CPU")
  if not bf16_err < bf16_bound:
    fail("the bfloat16 encoder strays from the float32 one")

  stats = {}
  for device in ("cpu", "cuda"):
    env = BatchedEnv("Town02", 4, num_vehicles=8, seed=4, device=device)
    _, _, s = env.rollout(10, policy=make_dim_policy(model(device)))
    stats[device] = {k: v.cpu() for k, v in s.items()}
  same = all(torch.equal(stats["cpu"][k], stats["cuda"][k])
             for k in ("episodes", "collisions"))
  dist_err = float((stats["cpu"]["distance"] -
                    stats["cuda"]["distance"]).abs().max())
  print("check dim rollout cuda vs cpu (Town02, 4 scenes, 8 NPCs, 10 "
        "steps): episodes/collisions equal={} distance_max_abs_diff={} "
        "(limit {}) distance_mean={:.3f}m".format(
            same, dist_err, DIM_DISTANCE_ATOL,
            float(stats["cpu"]["distance"].mean())))
  if not same or dist_err > DIM_DISTANCE_ATOL:
    fail("the DIM rollout on the card disagrees with the rollout on the CPU")


def drive_dim_path() -> int:
  """The DIM closed loop at full width; returns the splat's launches in
  the timed rollout."""
  import torch  # pylint: disable=import-outside-toplevel
  from oatomobile_torch import bench  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.envs.batched import BatchedEnv  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.ops import bev_cuda  # pylint: disable=import-outside-toplevel
  env = BatchedEnv(TOWN, BATCH, num_vehicles=VEHICLES, route_capacity=1024,
                   seed=0, device="cuda")
  policy = bench.dim_policy(100, "float32", device="cuda")
  t0 = time.perf_counter()
  _, _, s = env.rollout(DIM_WARMUP_STEPS, policy=policy)
  float(s["distance"].sum())
  warmup = time.perf_counter() - t0
  bev_cuda.launches = 0
  t0 = time.perf_counter()
  _, _, s = env.rollout(DIM_STEPS, policy=policy)
  float(s["distance"].sum())  # the fetch waits for the device
  elapsed = time.perf_counter() - t0
  launches = bev_cuda.launches
  s = {k: v.cpu() for k, v in s.items()}
  finite = all(bool(torch.isfinite(v.float()).all()) for v in s.values())
  print("dim path: {} x {} steps in {:.3f}s = {:.1f} env steps/s ({:.2f} "
        "ms a step; warm-up {} steps {:.1f}s); bev_splat launches={} for {} "
        "steps; stats finite={} distance_mean={:.2f}m episodes={} "
        "collisions={}".format(
            BATCH, DIM_STEPS, elapsed, BATCH * DIM_STEPS / elapsed,
            1e3 * elapsed / DIM_STEPS, DIM_WARMUP_STEPS, warmup, launches,
            DIM_STEPS, finite, float(s["distance"].mean()),
            int(s["episodes"].sum()), int(s["collisions"].sum())))
  if launches != DIM_STEPS:
    fail("bev_splat launched {} times in {} DIM steps".format(launches,
                                                              DIM_STEPS))
  if not finite or not bool((s["distance"] > 0).any()):
    fail("DIM path stats are not finite or no scene moved")
  stages = bench.policy_stage_ms(policy, env.params, env.state)
  print("dim policy call B={} (CUDA events, mean of 5): {}".format(
      BATCH, ", ".join("{} {:.3f} ms".format(k, v)
                       for k, v in stages.items())))
  return launches


def main() -> None:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--prev-splat", action="append", default=[],
                      help="another design's bev_splat.cu to check and time "
                      "beside this one")
  args = parser.parse_args()
  try:
    import torch  # pylint: disable=import-outside-toplevel
  except ImportError:
    fail("torch is not installed")
  if not torch.cuda.is_available():
    fail("no CUDA device (torch.cuda.is_available() is False)")
  sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
  try:
    from oatomobile_torch.envs.batched import BatchedEnv  # pylint: disable=import-outside-toplevel
    from oatomobile_torch.ops import bev, bev_cuda  # pylint: disable=import-outside-toplevel
  except ImportError as exc:
    fail("oatomobile_torch not found next to this script ({})".format(exc))
  if "jax" in sys.modules or "oatomobile_tpu" in sys.modules:
    fail("the port imported jax or oatomobile_tpu")
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False

  t_start = time.perf_counter()
  card = card_line()
  print("card: " + card)

  # -- 1. Build ------------------------------------------------------------
  t0 = time.perf_counter()
  bev_cuda.build()
  print("build: bev_splat {:.1f}s (nvcc {:.1f}s)".format(
      time.perf_counter() - t0, bev_cuda.build_seconds))
  print_build("bev_splat", bev_cuda, bev_cuda.LIBRARY)
  prevs = {}
  for source in args.prev_splat:
    name, library, launch = prev_splat(source, bev_cuda)
    prevs[name] = launch
    print("build: {} from {} (nvcc {:.1f}s)".format(name, source,
                                                   bev_cuda.build_seconds))
    print_build(name, bev_cuda, library)

  # -- 2. Kernel against its plain version on the card -----------------------
  max_abs_err = 0.0
  for batch in (64, BATCH):
    env = BatchedEnv(TOWN, batch, num_vehicles=VEHICLES, route_capacity=1024,
                     seed=0, device="cuda")
    env.rollout(20, compute=())
    cases = {"main": bev.gather_inputs(env.params, env.state),
             "stress": bev_cuda.stress_inputs(batch, batch, "cuda")}
    for case, inputs in cases.items():
      ref = bev_cuda.splat_lidar_batch_reference(*inputs)
      out = bev_cuda.splat_lidar_batch(*inputs)
      torch.cuda.synchronize()
      differing = count_differing(out, ref)
      err = float((out - ref).abs().max())
      print("check bev_splat {} B={}: max_abs_diff={} differing_pixels={} "
            "occupied_fraction={:.4f}".format(
                case, batch, err, differing,
                float((ref[..., 1] > 0).float().mean())))
      if differing:
        fail("bev_splat disagrees with its plain version on the {} inputs "
             "at B={}".format(case, batch))
      max_abs_err = max(max_abs_err, err)
      for name, launch in prevs.items():
        if case == "main":
          print("check {} {} B={}: differing_pixels={}".format(
              name, case, batch, count_differing(launch(*inputs), ref)))
    del env, cases, inputs, out, ref

  # -- 3. One splat captured in a CUDA graph, replayed on new inputs ---------
  static = [x.clone() for x in bev_cuda.stress_inputs(64, 1, "cuda")]
  bev_cuda.splat_lidar_batch(*static)
  torch.cuda.synchronize()
  graph = torch.cuda.CUDAGraph()
  with torch.cuda.graph(graph):
    captured = bev_cuda.splat_lidar_batch(*static)
  fresh = bev_cuda.stress_inputs(64, 2, "cuda")
  for dst, src in zip(static, fresh):
    dst.copy_(src)
  graph.replay()
  eager = bev_cuda.splat_lidar_batch(*fresh)
  torch.cuda.synchronize()
  differing = count_differing(captured, eager)
  print("check bev_splat graph replay on new inputs: differing_pixels={} "
        "(against the plain version: {})".format(
            differing, count_differing(
                captured, bev_cuda.splat_lidar_batch_reference(*fresh))))
  if differing:
    fail("the graph-captured splat disagrees with the eager call")
  del graph, captured, eager, static, fresh

  # -- 4. A small rollout on the card against the CPU ------------------------
  stats = {}
  for device in ("cpu", "cuda"):
    env = BatchedEnv("Town02", 4, num_vehicles=8, seed=4, device=device)
    _, _, s = env.rollout(30, compute=("lidar",))
    stats[device] = {k: v.cpu() for k, v in s.items()}
  same = all(torch.equal(stats["cpu"][k], stats["cuda"][k])
             for k in ("episodes", "collisions"))
  dist_err = float((stats["cpu"]["distance"] -
                    stats["cuda"]["distance"]).abs().max())
  sum_err = float(((stats["cpu"]["obs_checksum"] -
                    stats["cuda"]["obs_checksum"]).abs() /
                   stats["cpu"]["obs_checksum"].abs()).max())
  print("check rollout cuda vs cpu (Town02, 4 scenes, 8 NPCs, 30 steps): "
        "episodes/collisions equal={} distance_max_abs_diff={} "
        "checksum_max_rel_diff={}".format(same, dist_err, sum_err))
  if not same or dist_err > 1e-3 or sum_err > 1e-3:
    fail("the rollout on the card disagrees with the rollout on the CPU")

  # -- 5. Main path ------------------------------------------------------------
  env = BatchedEnv(TOWN, BATCH, num_vehicles=VEHICLES, route_capacity=1024,
                   seed=0, device="cuda")
  _, _, s = env.rollout(STEPS, compute=("lidar",))
  float(s["distance"].sum())
  bev_cuda.launches = 0
  t0 = time.perf_counter()
  final, _, s = env.rollout(STEPS, compute=("lidar",))
  float(s["distance"].sum())  # the fetch waits for the device
  elapsed = time.perf_counter() - t0
  launches = bev_cuda.launches
  s = {k: v.cpu() for k, v in s.items()}
  finite = all(bool(torch.isfinite(v.float()).all()) for v in s.values())
  print("main path: {} x {} steps in {:.3f}s = {:.1f} env steps/s; "
        "bev_splat launches={} (lidar syntheses={}); stats finite={} "
        "checksum_min={:.1f} distance_mean={:.2f}m episodes={} "
        "collisions={}".format(
            BATCH, STEPS, elapsed, BATCH * STEPS / elapsed, launches, STEPS,
            finite, float(s["obs_checksum"].min()),
            float(s["distance"].mean()), int(s["episodes"].sum()),
            int(s["collisions"].sum())))
  if launches != STEPS:
    fail("bev_splat launched {} times for {} lidar syntheses".format(
        launches, STEPS))
  if not finite or not bool((s["obs_checksum"] != 0).all()):
    fail("main path stats are not finite or a checksum is zero")

  # -- 6. Kernel timing at the main path's inputs ------------------------------
  inputs = bev.gather_inputs(env.params, final)
  designs = {"bev_splat": bev_cuda.splat_lidar_batch, **prevs}
  order = [*prevs, "bev_splat", "bev_splat", *reversed(list(prevs))]
  times = {name: [] for name in designs}
  for name in order:
    times[name].append(cuda_ms(lambda f=designs[name]: f(*inputs), calls=20))
  ms_of = {name: statistics.mean(t) for name, t in times.items()}
  ms = ms_of["bev_splat"]
  plain_ms = cuda_ms(lambda: bev_cuda.splat_lidar_batch_reference(*inputs),
                     calls=2)
  bound_ms, bound_by, slots = splat_bound_ms(*inputs)
  # Yardstick of what the card's memory gives a write of the same bytes.
  image = torch.empty((BATCH, 200, 200, 2), device="cuda")
  fill_ms = cuda_ms(lambda: image.fill_(0.0), calls=20)
  del image
  step_ms = 1e3 * elapsed / STEPS
  print("timing B={} in turn ({}): {}".format(
      BATCH, ", ".join(order), "; ".join(
          "{} {} ms".format(name, " ".join("{:.4f}".format(t) for t in ts))
          for name, ts in times.items())))
  print("timing bev_splat B={}: kernel {:.4f} ms, plain {:.4f} ms, bound "
        "{:.4f} ms ({}; {:.1f} live slots per scene), a fill of the same "
        "output {:.4f} ms, library none; {:.2%} of the main path's {:.3f} "
        "ms step".format(BATCH, ms, plain_ms, bound_ms, bound_by, slots,
                         fill_ms, ms / step_ms, step_ms))

  # -- 7. DIM on the card against the CPU ---------------------------------------
  check_dim_card_against_cpu()

  # -- 8. The DIM path ------------------------------------------------------------
  launches_dim = drive_dim_path()

  kernels = [{
      "name": "bev_splat",
      "status": "ported",
      "route": "cuda",
      "source": "oatomobile_torch/csrc/bev_splat.cu",
      "replaces": "oatomobile_tpu/ops/bev_pallas.py:54",
      "launches": launches,
      "launches_dim": launches_dim,
      "max_abs_err": max_abs_err,
      "ms": ms,
      "plain_ms": plain_ms,
      "bound_ms": bound_ms,
      "bound_by": bound_by,
      "library_ms": None,
      "prev_ms": ms_of[next(iter(prevs))] if prevs else None,
      "fill_ms": fill_ms,
  }]
  print("total: {:.1f}s".format(time.perf_counter() - t_start))
  print(json.dumps({"kernels": kernels}))
  print(card)
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
  main()
