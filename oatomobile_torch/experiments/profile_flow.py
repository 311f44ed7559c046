"""Profiles the flow under the DIM planner at 1024 scenes.  Port of the
JAX package's ``scripts/profile_flow.py``.

    python -m oatomobile_torch.experiments.profile_flow [--cpu] [-B 1024]
        [--iters 20] [--profile]

Decomposes one DIM plan into:
  - the encoder (MobileNetV2 -> z, ``params_z``),
  - one flow ``_inverse`` (the training's hot op),
  - ``log_prob`` (encoder and inverse),
  - ``plan20``: the encoder and 20 Adam steps of the flow's forward,
    inverse and gradient, eager and as a captured step's replay
    (``graphs.CapturedStep``; the JAX package jits it).

Prints one JSON line with the milliseconds of each (the best of
``--iters`` calls: CUDA events around the call on a card, the host's
clock on the CPU; ``backend`` says which) and the plan's share of
``plan20`` beyond the encoder, replayed and eager.  ``--profile`` adds the
replays' device busy ms, kernels and idle share (``utils.profiling``,
a card only).
"""

import argparse
import json
import time

import torch

from oatomobile_torch import device as device_lib
from oatomobile_torch import graphs
from oatomobile_torch.models.dim import ImitativeModel
from oatomobile_torch.utils import profiling

PLAN_STEPS, PLAN_LR = 20, 5e-2


def best_ms(fn, iters: int, device: torch.device) -> float:
  """The fastest of ``iters`` calls of ``fn()`` in ms, after one call."""
  fn()
  times = []
  for _ in range(iters):
    if device.type == "cuda":
      start = torch.cuda.Event(enable_timing=True)
      end = torch.cuda.Event(enable_timing=True)
      start.record()
      fn()
      end.record()
      end.synchronize()
      times.append(start.elapsed_time(end))
    else:
      t0 = time.perf_counter()
      fn()
      times.append(1e3 * (time.perf_counter() - t0))
  return min(times)


def inputs(batch: int, device: torch.device, size=(100, 100)) -> tuple:
  """(context, goal, y) of zeros, the JAX script's inputs."""
  context = {"visual_features": torch.zeros((batch, 2) + tuple(size),
                                            device=device),
             "velocity": torch.zeros((batch, 3), device=device),
             "is_at_traffic_light": torch.zeros((batch, 1), device=device),
             "traffic_light_state": torch.zeros((batch, 1), device=device)}
  return (context, torch.zeros((batch, 10, 2), device=device),
          torch.zeros((batch, 4, 2), device=device))


def run(batch: int = 1024, iters: int = 20, device="cuda", *,
        profile: bool = False) -> dict:
  """The line's numbers (module docstring)."""
  device = device_lib.resolve(device)
  if profile and device.type != "cuda":
    raise ValueError("--profile reads the card's kernels; it needs a card")
  model = ImitativeModel((4, 2), generator=torch.Generator().manual_seed(0),
                         device=device)
  model.requires_grad_(False)
  model.eval()
  context, goal, y = inputs(batch, device)
  with torch.no_grad():
    z = model.params_z(**context)

  def encoder():
    with torch.no_grad():
      return model.params_z(**context)

  def flow_inverse():
    with torch.no_grad():
      return model.decoder._inverse(y, z)  # pylint: disable=protected-access

  def log_prob():
    with torch.no_grad():
      return model.log_prob(y, **context)

  def plan20():
    return model.plan(num_steps=PLAN_STEPS, goal=goal, lr=PLAN_LR, **context)

  replay = graphs.CapturedStep(plan20, device, pool=graphs.new_pool(device))
  for _ in range(graphs.WARMUP_STEPS + 1):  # the warm-ups, the capture
    replay()
  results = {
      "B": batch,
      "backend": device.type,
      "encoder_ms": best_ms(encoder, iters, device),
      "flow_inverse_ms": best_ms(flow_inverse, iters, device),
      "log_prob_ms": best_ms(log_prob, iters, device),
      "plan20_ms": best_ms(plan20, iters, device),
      "plan20_replay_ms": best_ms(replay, iters, device),
  }
  for key, plan in (("plan_share_pct", "plan20_replay_ms"),
                    ("plan_share_pct_eager", "plan20_ms")):
    results[key] = round(100 * (results[plan] - results["encoder_ms"]) /
                         max(results[plan], 1e-9), 1)
  if profile:
    busy = profiling.device_busy(
        lambda: [replay() for _ in range(iters)], iters,
        results["plan20_replay_ms"])
    results["plan20_replay_busy_ms"] = busy["device_busy_ms_per_step"]
    results["plan20_replay_kernels"] = busy["kernels_per_step"]
    results["plan20_replay_idle_share"] = busy["idle_share"]
  return results


def line(results: dict) -> str:
  return json.dumps({k: round(v, 3) if isinstance(v, float) else v
                     for k, v in results.items()})


def main(argv=None) -> None:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("-B", type=int, default=1024)
  parser.add_argument("--iters", type=int, default=20)
  parser.add_argument("--cpu", action="store_true",
                      help="run on the CPU (default: the CUDA card)")
  parser.add_argument("--profile", action="store_true",
                      help="the replays' device busy time (a card only)")
  args = parser.parse_args(argv)
  print(line(run(args.B, args.iters, "cpu" if args.cpu else "cuda",
                 profile=args.profile)))


if __name__ == "__main__":
  main()
