"""Headline benchmark of the port: env steps/s at 1024 parallel BEV-sensor
scenes on one CUDA device.

    python -m oatomobile_torch.bench [--cpu]
    BENCH_MODE=dim python -m oatomobile_torch.bench

The workloads are the JAX package's ``bench.py``: Town01, 1024 scenes, 16
NPC vehicles, route capacity 1024, seed 0, 256 closed-loop steps; one
warm-up rollout (which captures the step into a CUDA graph), then one
timed rollout of graph replays ending in a small fetch to the host.  ``BENCH_MODE=autopilot`` (the default) drives the autopilot with
the 200x200x2 BEV LIDAR synthesised every step (``compute=("lidar",)``).
``BENCH_MODE=dim`` drives the learned DIM agent instead (BEV ->
MobileNetV2 -> flow -> 20 in-loop Adam steps -> PID), whose policy
synthesises the LIDAR once a step itself (``compute=()``); its weights are
random, drawn with flax's initial distributions from a seeded
``torch.Generator`` (no trained checkpoint exists), so they differ from
the JAX bench's ``model.init(PRNGKey(0))`` in value but not in
distribution.  ``BENCH_DIM_INPUT`` sets its visual input size (100) and
``BENCH_DIM_ENCODER_DTYPE`` its encoder's precision (``float32`` or
``bfloat16``; the planner stays float32).  float32 is IEEE float32 here:
TF32 is off for GEMMs and convolutions.

Other knobs: ``BENCH_BATCH``, ``BENCH_TOWN``, ``BENCH_VEHICLES``,
``BENCH_STEPS``.  ``BENCH_PROFILE=1`` adds, on stderr, the median device
ms of each span of the program in the replayed step (``autopilot`` or
``dim.observe``, ``dim.encode``, ``dim.plan``, ``dim.act``; then
``world_step``, ``sensors``, ``bookkeeping``; ``rollout.issue`` a step:
``utils.profiling.snapshot``'s marks of the last step of each rollout
call), and the device's busy time, operation count and idle share per step
of the captured rollout (``utils.profiling.device_busy``).

``--cpu`` runs the same workload on the CPU (as the JAX ``bench.py``
runs on whatever platform JAX has; ``BENCH_PROFILE`` needs the card).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}, with
``vs_baseline`` the ratio to the 100k steps/s north-star target.
"""

import argparse
import json
import os
import statistics
import sys
import time

import torch

from oatomobile_torch.envs.batched import BatchedEnv
from oatomobile_torch.utils import profiling


def mark_medians(snapshot: dict, origin: str = "replay") -> dict:
  """The median ms of each span's samples of ``origin`` in a
  ``profiling.snapshot()`` (per step for spans over several steps),
  by name."""
  out = {}
  for name, series in sorted(snapshot.items()):
    ms = [s.ms / s.count for s in series["samples"] if s.origin == origin]
    if ms:
      out[name] = statistics.median(ms)
  return out


def dim_policy(size: int = 100, encoder_dtype: str = "float32",
               device="cuda"):
  """The bench's DIM policy: ``ImitativeModel((4, 2), (size, size))`` with
  weights from ``torch.Generator().manual_seed(0)``, 20 plan steps."""
  from oatomobile_torch.baselines.learned.dim.policy import make_dim_policy  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.models import ImitativeModel  # pylint: disable=import-outside-toplevel
  model = ImitativeModel((4, 2), (size, size),
                         generator=torch.Generator().manual_seed(0),
                         device=device)
  return make_dim_policy(model, num_plan_steps=20,
                         encoder_dtype=encoder_dtype)


def main(argv=None) -> None:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--cpu", action="store_true",
                      help="run on the CPU (default: the CUDA card)")
  device = "cpu" if parser.parse_args(argv).cpu else "cuda"
  profile = os.environ.get("BENCH_PROFILE") == "1"
  if profile and device == "cpu":
    raise ValueError("BENCH_PROFILE=1 times the card: it needs one")
  batch = int(os.environ.get("BENCH_BATCH", 1024))
  town = os.environ.get("BENCH_TOWN", "Town01")
  num_vehicles = int(os.environ.get("BENCH_VEHICLES", 16))
  steps = int(os.environ.get("BENCH_STEPS", 256))
  mode = os.environ.get("BENCH_MODE", "autopilot")
  if mode not in ("autopilot", "dim"):
    raise ValueError("BENCH_MODE={!r}: 'autopilot' or 'dim'".format(mode))
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False

  env = BatchedEnv(town=town, batch_size=batch, num_vehicles=num_vehicles,
                   route_capacity=1024, seed=0, device=device)
  policy, rollout_kwargs = None, {"compute": ("lidar",)}
  metric = "env_steps_per_sec_per_chip_1024bev"
  if mode == "dim":
    policy = dim_policy(int(os.environ.get("BENCH_DIM_INPUT", 100)),
                        os.environ.get("BENCH_DIM_ENCODER_DTYPE", "float32"),
                        device)
    rollout_kwargs = {}
    metric = "dim_closed_loop_steps_per_sec_per_chip"

  # Warm-up: kernel build, allocator and one full run.
  _, _, stats = env.rollout(steps, policy=policy, **rollout_kwargs)
  float(stats["distance"].sum())

  t0 = time.perf_counter()
  _, _, stats = env.rollout(steps, policy=policy, **rollout_kwargs)
  float(stats["distance"].sum())  # the fetch waits for the device
  elapsed = time.perf_counter() - t0

  steps_per_sec = batch * steps / elapsed
  print(json.dumps({
      "metric": metric,
      "value": round(steps_per_sec, 1),
      "unit": "steps/s",
      "vs_baseline": round(steps_per_sec / 100_000.0, 3),
  }))
  print("diag: mode={} elapsed={:.2f}s batch={} steps={} dist/scene={:.1f}m "
        "collisions={} device={}".format(
            mode, elapsed, batch, steps, float(stats["distance"].mean()),
            int(stats["collisions"].sum()),
            torch.cuda.get_device_name(0) if device == "cuda" else "cpu"),
        file=sys.stderr)
  if profile:
    profile_steps = 16 if policy is None else 4
    # The last step of each rollout call, from the captured step's marks.
    print("marks_ms_per_step: " + json.dumps(
        mark_medians(profiling.snapshot())), file=sys.stderr)
    print("device: " + json.dumps(profiling.device_busy(
        lambda: env.rollout(profile_steps, policy=policy, **rollout_kwargs),
        profile_steps, 1e3 * elapsed / steps)), file=sys.stderr)


if __name__ == "__main__":
  main()
