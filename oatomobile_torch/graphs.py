"""Captured rollout steps: a step on static buffers, recorded once into a
CUDA graph and replayed.

The JAX package compiles its rollouts: ``jax.jit`` of a ``lax.scan`` whose
carry (the scene state, the stats, the key) is donated, so that each step
writes the next state into the buffers of the last.  The port's
counterpart is a step function that reads its inputs from static tensors
and writes its results back into them in place
(``sim.types.copy_state_``), run by :class:`CapturedStep`:

  - on a CUDA device, the first ``WARMUP_STEPS`` calls run the function
    eagerly on a side stream (they are real steps: the lazily made
    constants, the cuBLAS and cuDNN handles and the autograd engine's
    threads come into being there, outside any capture); the next call
    records it into a ``torch.cuda.CUDAGraph`` on that stream, in the
    memory pool it was given, and replays it; every later call is one
    ``replay()``.  A capture that fails raises: nothing runs the step
    eagerly in its place;
  - on the CPU every call runs the function eagerly, so the CPU tests run
    the code that the card captures.

A call returns the function's outputs: on the card the graph's own
tensors, which the next replay overwrites (copy what you keep).

Kernel launches: each hand-written kernel's wrapper counts its launches
in Python (``launches`` of every ``Kernel`` in ``native.nvcc.KERNELS``).
A capture runs the wrapper once and launches nothing, and a replay
launches without running it; so the runner takes back what the capture
counted and adds it again at each replay, and the counters read as the
eager loop's.

Marks (``utils.profiling``): the runner tells the profiling registry what
each call runs (eager, capture, replay).  The device marks that the step's
spans record during the capture are nodes of the graph; the runner keeps
them with the graph and hands them in after each replay.
"""

import gc
import time

import torch

from oatomobile_torch.native import nvcc
from oatomobile_torch.utils import profiling

# Eager calls on the side stream before the capture.
WARMUP_STEPS = 2

# Captures since import (or since the caller last reset them), the host
# seconds they took and the bytes the card reserved for them
# (``torch.cuda.memory_reserved`` after each capture less before it).
captures = 0
capture_seconds = 0.0
capture_bytes = 0


def new_pool(device):
  """A graph memory pool for the captures of one owner on ``device`` (None
  off CUDA): its graphs share the pool, as they replay one at a time."""
  if torch.device(device).type != "cuda":
    return None
  return torch.cuda.graph_pool_handle()


class CapturedStep:
  """``step()`` runs ``fn()`` as the module docstring says."""

  def __init__(self, fn, device, pool=None) -> None:
    self._fn = fn
    self._cuda = torch.device(device).type == "cuda"
    self._pool = pool
    self._stream = None
    self._warm = 0
    self._graph = None
    self._outputs = None
    # The launches of each kernel that one replay makes.
    self._launches = {}
    # The graph's device marks: they live as long as the graph.
    self._marks = ()

  @property
  def captured(self) -> bool:
    return self._graph is not None

  def __call__(self):
    if not self._cuda:
      with profiling.running("eager"):
        return self._fn()
    if self._graph is None:
      if self._warm < WARMUP_STEPS:
        self._warm += 1
        with profiling.running("eager"):
          return self._run_on_side_stream()
      before = {kernel: kernel.launches for kernel in nvcc.KERNELS}
      with profiling.running("capture") as marks:
        self._graph, self._outputs = self._record()
      self._marks = tuple(marks)
      # What the capture counted (a kernel first made inside it counted
      # from 0) is launched by each replay.
      for kernel in nvcc.KERNELS:
        counted = kernel.launches - before.get(kernel, 0)
        kernel.launches -= counted
        if counted:
          self._launches[kernel] = counted
    with profiling.running("replay"):
      self._graph.replay()
    profiling.replayed(self._marks)
    for kernel, n in self._launches.items():
      kernel.launches += n
    return self._outputs

  def _side_stream(self) -> torch.cuda.Stream:
    if self._stream is None:
      self._stream = torch.cuda.Stream()
    return self._stream

  def _run_on_side_stream(self):
    stream = self._side_stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
      out = self._fn()
    torch.cuda.current_stream().wait_stream(stream)
    return out

  def _record(self):
    """(graph, outputs) of ``fn`` captured on the side stream."""
    global captures, capture_seconds, capture_bytes
    t0 = time.perf_counter()
    # Graphs that only a reference cycle keeps (an env and its steps) are
    # freed now: the collector must not destroy one during the capture,
    # which that would invalidate, so it is off until the capture ends.
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    graph = torch.cuda.CUDAGraph()
    collecting = gc.isenabled()
    gc.disable()
    try:
      with profiling.span("capture"), torch.cuda.graph(
          graph, pool=self._pool, stream=self._side_stream()):
        outputs = self._fn()
    finally:
      if collecting:
        gc.enable()
    captures += 1
    capture_seconds += time.perf_counter() - t0
    capture_bytes += torch.cuda.memory_reserved() - reserved
    return graph, outputs
