"""Reading a ``torch.profiler`` trace of the card: device operations, busy
time, idle gaps by what the host was doing, and the device time of the
benchmark's own spans (``torch.profiler.record_function`` around its
calls into each layer of the program).

The busy arithmetic is the program's ``utils.profiling.device_busy``
(summed device time of the kernels against an unprofiled step), copied
here so that a change to the program cannot move it; the busy time is
the union of the device operations' intervals, so that operations that
overlap count once.
"""

import contextlib
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

Interval = Tuple[float, float]
# Every span of the benchmark's is named with this prefix.
PREFIX = "perfbench."


@contextlib.contextmanager
def span(name: str, sync: bool = False):
  """A span of the benchmark's own, ``perfbench.<name>``, around a call
  into the program; with ``sync`` it ends with a device synchronise, so
  that every device operation it launched runs inside it."""
  with torch.profiler.record_function(PREFIX + name):
    yield
    if sync:
      torch.cuda.synchronize()


class Trace:
  """What one profiled block ran: CPU spans and device operations, in
  microseconds from the trace's start, and the block's host seconds."""

  def __init__(self, prof, seconds: float) -> None:
    self.seconds = seconds
    events = list(prof.events())
    cuda = torch.autograd.DeviceType.CUDA
    self.spans = [e for e in events
                  if e.device_type != cuda and _is_annotation(e)]
    span_names = {e.name for e in self.spans}
    # Device operations: kernels, copies and fills; the GPU side of a
    # span (a "gpu_user_annotation") covers other operations and is left
    # out.
    self.device_ops = [e for e in events
                       if e.device_type == cuda and e.name not in span_names
                       and not _is_annotation(e)]

  def intervals(self, name_part: Optional[str] = None) -> List[Interval]:
    return [(e.time_range.start, e.time_range.end) for e in self.device_ops
            if name_part is None or name_part in e.name]

  def busy_us(self) -> float:
    return sum(b - a for a, b in merged(self.intervals()))

  def kernel_count(self) -> int:
    return len(self.device_ops)

  def top_ops(self, n: int = 10) -> List[list]:
    """[[name, seconds], ...]: the device operations that took most time,
    summed by name."""
    totals: Dict[str, float] = {}
    for e in self.device_ops:
      totals[e.name] = totals.get(e.name, 0.0) + (
          e.time_range.end - e.time_range.start) / 1e6
    return [[k, v] for k, v in sorted(totals.items(),
                                      key=lambda kv: -kv[1])[:n]]

  def idle_gaps(self, n: int = 10) -> List[list]:
    """[[host activity, seconds], ...]: the device's idle time inside the
    traced block, summed by the innermost span of the benchmark's that
    was open on the host at each gap's midpoint ("host" outside them)."""
    busy = merged(self.intervals())
    if not busy:
      return []
    totals: Dict[str, float] = {}
    for (_, end), (start, _) in zip(busy, busy[1:]):
      if start <= end:
        continue
      mid = 0.5 * (start + end)
      label = "host"
      width = float("inf")
      for s in self.spans:
        a, b = s.time_range.start, s.time_range.end
        if a <= mid <= b and b - a < width:
          label, width = s.name[len(PREFIX):], b - a
      totals[label] = totals.get(label, 0.0) + (start - end) / 1e6
    return [[k, v] for k, v in sorted(totals.items(),
                                      key=lambda kv: -kv[1])[:n]]

  def span_device_us(self, name: str) -> Optional[float]:
    """Summed device time of the operations that started inside an
    occurrence of the span ``name`` (a span opened with ``sync``, not
    overlapping another, holds just the operations it launched, whatever
    thread launched them: autograd's backward runs on a thread of its
    own); None where the span never ran."""
    hits = [(e.time_range.start, e.time_range.end) for e in self.spans
            if e.name == PREFIX + name]
    if not hits:
      return None
    total = 0.0
    for e in self.device_ops:
      t = e.time_range.start
      if any(a <= t <= b for a, b in hits):
        total += e.time_range.end - t
    return total


def _is_annotation(event) -> bool:
  return (event.name.startswith(PREFIX) or
          bool(getattr(event, "is_user_annotation", False)))


def merged(intervals: Sequence[Interval]) -> List[Interval]:
  """The union of intervals as sorted disjoint intervals."""
  out: List[Interval] = []
  for a, b in sorted(intervals):
    if out and a <= out[-1][1]:
      out[-1] = (out[-1][0], max(out[-1][1], b))
    else:
      out.append((a, b))
  return out


def profile(run: Callable[[], object]) -> Trace:
  """Profiles ``run()`` (CPU ops and CUDA activity) between two device
  synchronises; the trace's host seconds are the block's."""
  from torch.profiler import ProfilerActivity  # pylint: disable=import-outside-toplevel
  torch.cuda.synchronize()
  with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                          ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
  return Trace(prof, seconds)
