"""Profiling and throughput accounting: port of the JAX package's
``utils/profiling.py``, and the program's own spans and device-clock
marks.

  - ``Meter``: steps/s and steps/s per card, smoothed by an EMA;
  - ``trace``: a ``torch.profiler`` trace of a block, written as a Chrome
    trace (view it in Perfetto or ``chrome://tracing``);
  - ``timed``: host wall time of a call that ends by fetching one element
    of its result to the host (PyTorch returns before the device is done,
    so a clock without a fetch would time the launches only);
  - ``device_busy``: from a profiler trace of a run of rollout steps, the
    device operations a step, the device's busy ms a step and its idle
    share;
  - ``span``: a named block of the program.  Under a running
    ``torch.profiler`` it is a ``record_function("oatomobile.<name>")``
    on the host, on the trace's clock beside the device operations; with
    a ``device`` it also takes device-clock marks at its ends, always.

Marks.  On a card a mark is a timing ``torch.cuda.Event`` recorded on the
current stream; inside a CUDA-graph capture (``graphs.CapturedStep``) it
is recorded with ``external=True``, so that it becomes a node of the graph
that every replay records again; on the CPU it is
``time.perf_counter()`` (eager CPU work is synchronous).  A span that
opens right after a sibling span with marks closed (the same parent, no
span between) starts at that sibling's end mark: consecutive spans split
their parent's time, and any code between two of them counts to the
later one.

Reading never synchronises.  Marks on the CPU are read when their span
closes; marks on a card once ``query()`` says they are complete, at
``snapshot()`` and around each root span (one with no parent): a captured
step's marks when it opens, before a replay records them again, the
others when it closes, while the card works on what it launched.  A
captured step's marks hold the times of its last replay: each replay
hands them in (``replayed``) in place of the one before, so a rollout
call reads the last step of the call before it.  Each read is a
``Sample`` in a registry bounded per name (count and sum since ``reset``,
the last ``SAMPLES_PER_NAME`` samples): ``snapshot()`` returns it.  The
registry is a module's state, for one thread.
"""

import collections
import contextlib
import dataclasses
import os
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional

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


def _union_us(intervals) -> float:
  """The length of the union of (start, end) intervals."""
  total, reach = 0.0, float("-inf")
  for a, b in sorted(intervals):
    if b > reach:
      total += b - max(a, reach)
      reach = b
  return total


def _is_span(event) -> bool:
  return (event.name.startswith(SPAN_PREFIX) or
          bool(getattr(event, "is_user_annotation", False)))


def busy_of_events(events, steps: int, step_ms: float) -> dict:
  """``device_busy``'s numbers from a profiler's ``events()``: the device
  operations (the device side of a span left out), their busy time as
  the union of their intervals (operations that overlap count once) a
  step, and the idle share of a step of ``step_ms``."""
  ops = [e for e in events
         if e.device_type == torch.autograd.DeviceType.CUDA
         and not _is_span(e)]
  busy_ms = _union_us((e.time_range.start, e.time_range.end)
                      for e in ops) / 1e3 / steps
  return {"device_busy_ms_per_step": busy_ms,
          "kernels_per_step": len(ops) / steps,
          "step_ms": step_ms,
          "idle_share": 1.0 - busy_ms / step_ms}


def device_busy(run: Callable[[], Any], steps: int,
                step_ms: float) -> dict:
  """Device time per step from a ``torch.profiler`` trace of ``run()``,
  which runs ``steps`` rollout steps on the card (``busy_of_events``);
  the idle share is against an unprofiled step of ``step_ms`` (the
  trace's own wall time is inflated by the profiler)."""
  from torch.profiler import ProfilerActivity, profile  # pylint: disable=import-outside-toplevel
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    run()
    torch.cuda.synchronize()
  return busy_of_events(prof.events(), steps, step_ms)


# -- spans, marks and their registry ------------------------------------------

SPAN_PREFIX = "oatomobile."
SAMPLES_PER_NAME = 4096
# Card marks recorded outside a capture and not read yet (the oldest go
# first beyond this).
PENDING_READS = 4096
# What ``graphs.CapturedStep`` runs, by precedence: a span over several
# calls takes the highest.
ORIGINS = ("replay", "eager", "capture")


class Sample(NamedTuple):
  """One read of a span's marks.

  ``index`` counts the calls of the span's root (the rollout call or the
  update it belongs to); ``profiled``: a ``torch.profiler`` was running;
  ``origin``: "replay" (a captured step's replay, or a span around
  replays only), "capture", or "eager"; ``ms``: from the span's start
  mark to its end mark; ``count``: the steps it covers; ``gap_ms`` and
  ``period_ms``: from the end and from the start of the last span of
  that name on that device outside a capture to this one's start (None
  for the first, and inside a capture)."""
  name: str
  parent: Optional[str]
  index: int
  profiled: bool
  origin: str
  ms: float
  count: int = 1
  gap_ms: Optional[float] = None
  period_ms: Optional[float] = None


class _Series:
  __slots__ = ("count", "sum_ms", "samples")

  def __init__(self) -> None:
    self.count = 0
    self.sum_ms = 0.0
    self.samples = collections.deque(maxlen=SAMPLES_PER_NAME)


class _Frame:
  __slots__ = ("name", "index", "origin", "cursor")

  def __init__(self, name: str, index: int, origin: Optional[str]) -> None:
    self.name = name
    self.index = index
    self.origin = origin
    # The end mark of the last child that closed with marks, as
    # (device type, mark); None once another child closed without.
    self.cursor = None


_series: Dict[str, _Series] = {}
_stack: List[_Frame] = []
_roots: Dict[str, int] = {}
# (name, device type) -> (start, end) of the last span of that name on
# that device outside a capture.
_previous: Dict[str, tuple] = {}
_pending: collections.deque = collections.deque(maxlen=PENDING_READS)
# id(marks) -> (marks, root index, profiled) of a captured step's last
# replay; marks are (name, parent, count, start, end) events of its graph.
_replays: Dict[int, tuple] = {}
_mode: Optional[str] = None
_captured: Optional[list] = None


def _profiling() -> bool:
  return torch.autograd._profiler_enabled()  # pylint: disable=protected-access


def _device_type(device) -> Optional[str]:
  if device is None:
    return None
  return getattr(device, "type", None) or torch.device(device).type


def _mark(kind: str, capturing: bool = False):
  if kind != "cuda":
    return time.perf_counter()
  event = torch.cuda.Event(enable_timing=True, external=capturing)
  event.record()
  return event


def _elapsed_ms(start, end) -> float:
  if isinstance(start, float):
    return 1e3 * (end - start)
  return start.elapsed_time(end)


def _complete(marks) -> bool:
  return all(isinstance(m, float) or m.query() for m in marks)


def _note(kind: str) -> None:
  rank = ORIGINS.index(kind)
  for frame in _stack:
    if frame.origin is None or ORIGINS.index(frame.origin) < rank:
      frame.origin = kind


def _add(sample: Sample) -> None:
  series = _series.get(sample.name)
  if series is None:
    series = _series[sample.name] = _Series()
  series.count += 1
  series.sum_ms += sample.ms
  series.samples.append(sample)


def _read(sample: Sample, start, end, previous) -> Sample:
  gap = period = None
  if previous is not None:
    gap = _elapsed_ms(previous[1], start)
    period = _elapsed_ms(previous[0], start)
  return sample._replace(ms=_elapsed_ms(start, end), gap_ms=gap,
                         period_ms=period)


def _read_replays() -> None:
  """Reads the captured steps' marks whose replay is complete."""
  for key, (marks, index, profiled) in list(_replays.items()):
    # A graph's marks are recorded in order on one stream: the last one
    # complete means all are.
    if _complete((marks[-1][4],)):
      del _replays[key]
      for name, parent, count, start, end in marks:
        _add(Sample(name, parent, index, profiled, "replay",
                    _elapsed_ms(start, end), count))


def _read_pending() -> None:
  """Reads the card marks recorded outside a capture that are complete;
  keeps the others."""
  waiting = []
  while _pending:
    sample, start, end, previous = read = _pending.popleft()
    if _complete((start, end) + (previous or ())):
      _add(_read(sample, start, end, previous))
    else:
      waiting.append(read)
  _pending.extend(waiting)


@contextlib.contextmanager
def span(name: str, device=None, count: int = 1):
  """A named block of the program (module docstring): a host span under
  a running profiler and, with ``device`` (a device or its name), marks
  on that device's clock; ``count`` is the steps it covers."""
  parent = _stack[-1] if _stack else None
  # A capture must not query or free events.
  reading = parent is None and _mode != "capture"
  if parent is None:
    if reading:
      _read_replays()
    index = _roots.get(name, 0)
    _roots[name] = index + 1
  else:
    index = parent.index
  kind = _device_type(device)
  capturing = kind == "cuda" and torch.cuda.is_current_stream_capturing()
  # Marks inside a capture need a ``CapturedStep`` to keep them alive.
  marking = kind is not None and (not capturing or _captured is not None)
  start = None
  if marking:
    if parent is not None and parent.cursor is not None and \
        parent.cursor[0] == kind:
      start = parent.cursor[1]
    else:
      start = _mark(kind, capturing)
  profiled = _profiling()
  host = None
  if profiled:
    host = torch.profiler.record_function(SPAN_PREFIX + name)
    host.__enter__()
  frame = _Frame(name, index, _mode)
  _stack.append(frame)
  try:
    yield
  finally:
    _stack.pop()
    if host is not None:
      host.__exit__(None, None, None)
    if parent is not None:
      parent.cursor = None
  # Only a block that ran to its end is marked.
  if marking:
    end = _mark(kind, capturing)
    parent_name = None if parent is None else parent.name
    if parent is not None:
      parent.cursor = (kind, end)
    if capturing:
      _captured.append((name, parent_name, count, start, end))
      return
    previous = _previous.get((name, kind))
    _previous[(name, kind)] = (start, end)
    sample = Sample(name, parent_name, index, profiled,
                    frame.origin or "eager", 0.0, count)
    if kind == "cuda":
      _pending.append((sample, start, end, previous))
    else:
      _add(_read(sample, start, end, previous))
  if reading:
    _read_pending()


class running:  # pylint: disable=invalid-name
  """``with running(kind)``: ``graphs.CapturedStep`` runs its step as
  ``kind`` ("eager", "capture" or "replay"); the open spans and those that
  open inside take it as their origin.  For "capture" it yields the list
  that the capture's marks go into, for the ``CapturedStep`` to keep with
  its graph."""

  def __init__(self, kind: str) -> None:
    self._kind = kind
    self._saved = None

  def __enter__(self):
    global _mode, _captured
    self._saved = (_mode, _captured)
    _note(self._kind)
    _mode = self._kind
    if self._kind == "capture":
      _captured = []
    return _captured

  def __exit__(self, *exc) -> None:
    global _mode, _captured
    _mode, _captured = self._saved


def replayed(marks) -> None:
  """A replay of the graph that holds ``marks`` (``running("capture")``'s
  list, as a tuple) was launched: its marks now time this replay."""
  if marks:
    index = _stack[0].index if _stack else 0
    _replays[id(marks)] = (marks, index, _profiling())


def snapshot() -> Dict[str, dict]:
  """The registry after reading what is complete: per name its ``count``
  and ``sum_ms`` since ``reset`` and its last ``samples``."""
  _read_replays()
  _read_pending()
  return {name: {"count": s.count, "sum_ms": s.sum_ms,
                 "samples": list(s.samples)}
          for name, s in _series.items()}


def reset() -> None:
  """Empties the registry and drops the marks not read yet."""
  _series.clear()
  _roots.clear()
  _previous.clear()
  _pending.clear()
  _replays.clear()
