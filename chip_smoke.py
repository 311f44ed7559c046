#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``oatomobile_torch``).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc).  It:

  1. prints the card's name and power limit (nvidia-smi);
  2. builds every kernel of the main path from the sources in this
     checkout (the BEV splat, csrc/bev_splat.cu) and prints the build time
     and what ptxas reports;
  3. holds each kernel against its plain PyTorch version on the card, on
     the inputs the main path gives it (Town01, 16 NPCs, after 20 autopilot
     steps) at 64 and 1024 scenes;
  4. runs a small rollout on the card and on the CPU and holds the episode
     stats against each other;
  5. drives the main path: ``BatchedEnv("Town01", 1024, num_vehicles=16,
     route_capacity=1024, seed=0).rollout(256, compute=("lidar",))`` once
     to warm up and once timed, with every kernel's launch count set to 0
     just before the timed run and read just after;
  6. times each kernel (CUDA events around back-to-back calls, median
     of 21 runs) beside its plain version and its bound;
  7. prints one JSON line of the kernels and, last, the ok/device line.

Any failure exits non-zero before the last line.  Without a CUDA device,
or outside a checkout of the repository, it exits 1 and prints no result.
"""

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

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM bandwidth and
# FP32 rate outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# FP32 operations per pixel-slot test of the splat: u and v are two
# products and two sums each, then two compares (|x| <= h, the abs being
# an operand modifier).
OPS_PER_TEST = 10
# Kernel against plain version: pixels allowed to differ.  The kernel
# rounds every product and sum as the plain version does (no FMA), so the
# expected difference is none; a pixel whose centre lies within rounding
# of a rect edge is the only way one could differ.
EDGE_FRACTION = 1e-4


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


def main() -> None:
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
  for line in bev_cuda.build_log.splitlines():
    if "registers" in line or "bytes stack" in line:
      print("ptxas: " + line.strip())

  # -- 2. Kernel against its plain version on the card -----------------------
  max_abs_err = 0.0
  for batch in (64, BATCH):
    env = BatchedEnv(TOWN, batch, num_vehicles=VEHICLES, route_capacity=1024,
                     seed=0, device="cuda")
    env.rollout(20, compute=())
    inputs = bev.gather_inputs(env.params, env.state)
    out = bev_cuda.splat_lidar_batch(*inputs)
    ref = bev_cuda.splat_lidar_batch_reference(*inputs)
    torch.cuda.synchronize()
    diff = (out - ref).abs()
    err = float(diff.max())
    frac = float((diff > 0).float().mean())
    occupied = float((out[..., 1] > 0).float().mean())
    print("check bev_splat B={}: max_abs_diff={} differing_fraction={} "
          "occupied_fraction={:.4f}".format(batch, err, frac, occupied))
    if not torch.isfinite(out).all() or frac >= EDGE_FRACTION:
      fail("bev_splat disagrees with its plain version at B={}".format(
          batch))
    max_abs_err = max(max_abs_err, err)
    del env, inputs, out, ref, diff

  # -- 3. A small rollout on the card against the CPU ------------------------
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

  # -- 4. Main path ------------------------------------------------------------
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

  # -- 5. Kernel timing at the main path's inputs ------------------------------
  inputs = bev.gather_inputs(env.params, final)
  ms = cuda_ms(lambda: bev_cuda.splat_lidar_batch(*inputs), calls=20)
  plain_ms = cuda_ms(lambda: bev_cuda.splat_lidar_batch_reference(*inputs),
                     calls=2)
  bound_ms, bound_by, slots = splat_bound_ms(*inputs)
  print("timing bev_splat B={}: kernel {:.4f} ms, plain {:.4f} ms, bound "
        "{:.4f} ms ({}; {:.1f} live slots per scene), library none".format(
            BATCH, ms, plain_ms, bound_ms, bound_by, slots))

  kernels = [{
      "name": "bev_splat",
      "status": "ported",
      "route": "cuda",
      "source": "oatomobile_torch/csrc/bev_splat.cu",
      "replaces": "oatomobile_tpu/ops/bev_pallas.py:54",
      "launches": launches,
      "max_abs_err": max_abs_err,
      "ms": ms,
      "plain_ms": plain_ms,
      "bound_ms": bound_ms,
      "bound_by": bound_by,
      "library_ms": None,
  }]
  print("total: {:.1f}s".format(time.perf_counter() - t_start))
  print(json.dumps({"kernels": kernels}))
  print(card)
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
  main()
