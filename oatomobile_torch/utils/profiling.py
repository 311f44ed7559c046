"""Profiling and throughput accounting: port of the JAX package's
``utils/profiling.py``.

  - ``Meter``: steps/s and steps/s per card, smoothed by an EMA;
  - ``trace``: a ``torch.profiler`` trace of a block, written as a Chrome
    trace (view it in Perfetto or ``chrome://tracing``);
  - ``timed``: host wall time of a call that ends by fetching one element
    of its result to the host (PyTorch returns before the device is done,
    so a clock without a fetch would time the launches only);
  - ``device_busy``: from a profiler trace of a run of rollout steps, the
    kernels a step, the device's busy ms a step and its idle share.
"""

import contextlib
import dataclasses
import os
import time
from typing import Any, Callable, Optional

import torch


def num_cards() -> int:
  """CUDA devices visible to this process, or 1 (the CPU) without any."""
  return max(torch.cuda.device_count(), 1)


class Meter:
  """Throughput meter: call ``update(n_steps)`` after each device call."""

  def __init__(self, ema: float = 0.9) -> None:
    self._ema = ema
    self._rate = None
    self._last = None
    self.total_steps = 0

  def start(self) -> None:
    self._last = time.perf_counter()

  def update(self, n_steps: int) -> float:
    now = time.perf_counter()
    if self._last is None:
      self._last = now
      return 0.0
    dt = now - self._last
    self._last = now
    self.total_steps += n_steps
    rate = n_steps / max(dt, 1e-9)
    self._rate = rate if self._rate is None else (
        self._ema * self._rate + (1 - self._ema) * rate)
    return rate

  @property
  def steps_per_sec(self) -> float:
    return self._rate or 0.0

  @property
  def steps_per_sec_per_chip(self) -> float:
    return (self._rate or 0.0) / num_cards()


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str):
  """Profiles the block (CPU ops, and CUDA kernels where a card is
  present) and writes ``log_dir/trace.json`` when it ends; yields the
  ``torch.profiler.profile`` object."""
  from torch.profiler import ProfilerActivity, profile  # pylint: disable=import-outside-toplevel
  activities = [ProfilerActivity.CPU]
  if torch.cuda.is_available():
    activities.append(ProfilerActivity.CUDA)
  os.makedirs(log_dir, exist_ok=True)
  prof = profile(activities=activities)
  prof.start()
  try:
    yield prof
  finally:
    prof.stop()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def _first_tensor(tree) -> Optional[torch.Tensor]:
  """The first tensor leaf of nested tuples, lists, dicts and
  dataclasses."""
  if isinstance(tree, torch.Tensor):
    return tree
  if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
    tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
  elif isinstance(tree, dict):
    tree = list(tree.values())
  if isinstance(tree, (list, tuple)):
    for leaf in tree:
      found = _first_tensor(leaf)
      if found is not None:
        return found
  return None


def timed(computation: Callable, *args, fetch: Optional[Callable] = None,
          **kwargs):
  """Runs ``computation(*args, **kwargs)``; returns (result, seconds).

  Completion is forced by fetching one element of ``fetch(result)``
  (default: the result's first tensor leaf) to the host."""
  t0 = time.perf_counter()
  result = computation(*args, **kwargs)
  probe = fetch(result) if fetch is not None else _first_tensor(result)
  if probe is not None:
    probe.reshape(-1)[:1].cpu()
  return result, time.perf_counter() - t0


def device_busy(run: Callable[[], Any], steps: int,
                step_ms: float) -> dict:
  """Device time per step from a ``torch.profiler`` trace of ``run()``,
  which runs ``steps`` rollout steps on the card: the summed self time of
  every kernel, the number of kernels, and the idle share of an
  unprofiled step of ``step_ms`` (the trace's own wall time is inflated
  by the profiler)."""
  from torch.profiler import ProfilerActivity, profile  # pylint: disable=import-outside-toplevel
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    run()
    torch.cuda.synchronize()
  kernels = [e for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
  busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
  return {"device_busy_ms_per_step": busy_ms,
          "kernels_per_step": len(kernels) / steps,
          "step_ms": step_ms,
          "idle_share": 1.0 - busy_ms / step_ms}
