"""Headline benchmark of the port: env steps/s at 1024 parallel BEV-sensor
scenes on one CUDA device.

    python -m oatomobile_torch.bench

The workload is the JAX package's ``bench.py``: Town01, 1024 scenes, 16
NPC vehicles, route capacity 1024, seed 0, 256 closed-loop autopilot
steps with the 200x200x2 BEV LIDAR synthesised every step; one warm-up
rollout, then one timed rollout ending in a small fetch to the host.
Knobs: ``BENCH_BATCH``, ``BENCH_TOWN``, ``BENCH_VEHICLES``,
``BENCH_STEPS``, ``BENCH_MODE`` (only ``autopilot``: the learned DIM
agent is not ported yet).  ``BENCH_PROFILE=1`` adds, on stderr, a
per-layer breakdown of a step and the device's busy time, kernel count
and idle share per step from a profiler trace.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}, with
``vs_baseline`` the ratio to the 100k steps/s north-star target.
"""

import json
import os
import sys
import time

import torch

from oatomobile_torch.envs.batched import BatchedEnv
from oatomobile_torch.ops import bev, bev_cuda
from oatomobile_torch.sim import autopilot_policy, world_step


def layer_times(env: BatchedEnv, steps: int = 20) -> dict:
  """Mean milliseconds per step of each layer of the rollout body, timed
  on the host clock with a device synchronise after each layer (so the
  layers do not overlap; their sum exceeds an unsynchronised step)."""
  params, state = env.params, env.state
  totals = {}

  def timed(name, fn, *args):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    totals[name] = totals.get(name, 0.0) + (time.perf_counter() - t0)
    return out

  for _ in range(steps):
    actions, state = timed("autopilot", autopilot_policy, params, state)
    new_state = timed("world_step", world_step, params, state, actions)
    inputs = timed("bev_gather", bev.gather_inputs, params, new_state)
    image = timed("bev_kernel", bev_cuda.splat_lidar_batch, *inputs)
    timed("checksum", lambda x: x.reshape(x.shape[0], -1).sum(-1), image)
    done = timed("done", env._done, new_state)  # pylint: disable=protected-access
    state = timed("auto_reset", env._reset_where_done, new_state, done)  # pylint: disable=protected-access
  return {name: 1e3 * t / steps for name, t in totals.items()}


def device_busy(env: BatchedEnv, step_ms: float, steps: int = 16) -> dict:
  """Device time per step from a ``torch.profiler`` trace of ``steps``
  rollout steps: the summed self time of every kernel on the card, the
  number of kernels, and the idle share of an unprofiled step of
  ``step_ms`` (the trace's own wall time is inflated by the profiler)."""
  from torch.profiler import ProfilerActivity, profile  # pylint: disable=import-outside-toplevel
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    env.rollout(steps, compute=("lidar",))
    torch.cuda.synchronize()
  kernels = [e for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
  busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
  return {"device_busy_ms_per_step": busy_ms,
          "kernels_per_step": len(kernels) / steps,
          "step_ms": step_ms,
          "idle_share": 1.0 - busy_ms / step_ms}


def main() -> None:
  batch = int(os.environ.get("BENCH_BATCH", 1024))
  town = os.environ.get("BENCH_TOWN", "Town01")
  num_vehicles = int(os.environ.get("BENCH_VEHICLES", 16))
  steps = int(os.environ.get("BENCH_STEPS", 256))
  mode = os.environ.get("BENCH_MODE", "autopilot")
  if mode != "autopilot":
    raise NotImplementedError(
        "BENCH_MODE={!r}: the learned agents are not ported to "
        "oatomobile_torch yet; only 'autopilot' runs".format(mode))

  env = BatchedEnv(town=town, batch_size=batch, num_vehicles=num_vehicles,
                   route_capacity=1024, seed=0, device="cuda")

  # Warm-up: kernel build, allocator and one full run.
  _, _, stats = env.rollout(steps, compute=("lidar",))
  float(stats["distance"].sum())

  t0 = time.perf_counter()
  _, _, stats = env.rollout(steps, compute=("lidar",))
  float(stats["distance"].sum())  # the fetch waits for the device
  elapsed = time.perf_counter() - t0

  steps_per_sec = batch * steps / elapsed
  print(json.dumps({
      "metric": "env_steps_per_sec_per_chip_1024bev",
      "value": round(steps_per_sec, 1),
      "unit": "steps/s",
      "vs_baseline": round(steps_per_sec / 100_000.0, 3),
  }))
  print("diag: elapsed={:.2f}s batch={} steps={} dist/scene={:.1f}m "
        "collisions={} device={}".format(
            elapsed, batch, steps, float(stats["distance"].mean()),
            int(stats["collisions"].sum()), torch.cuda.get_device_name(0)),
        file=sys.stderr)
  if os.environ.get("BENCH_PROFILE") == "1":
    print("layers_ms_per_step: " + json.dumps(layer_times(env)),
          file=sys.stderr)
    print("device: " + json.dumps(device_busy(env, 1e3 * elapsed / steps)),
          file=sys.stderr)


if __name__ == "__main__":
  main()
