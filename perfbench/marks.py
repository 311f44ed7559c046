"""The program's own spans and device-clock marks, as the per-layer
metrics of source ``program_span`` read them: the samples of
``oatomobile_torch.utils.profiling.snapshot()`` (one read of a span's
marks each; see that module).

A reader uses only samples taken while no ``torch.profiler`` ran, so the
traced passes after the window are left out.  What remains is the window
and a few chunks or updates of the set-up (those after the capture, the
first updates): medians are robust to them, and the idle shares leave
out the set-up's pauses (below).  Every function returns None, and
raises nothing, where the program has no such registry (a program older
than it) or no sample of the span.
"""

import statistics
from typing import List, Optional

# A pair of spans further apart than this many times their median
# distance has a pause between them that is no part of the loop: the
# set-up's capture or its host-card copies.
PAUSE = 10.0


def samples(name: str, origin: Optional[str] = None) -> List:
  """The unprofiled samples of the program's span ``name`` (of
  ``origin`` where given: "replay" for a captured step's replays)."""
  try:
    from oatomobile_torch.utils import profiling  # pylint: disable=import-outside-toplevel
  except ImportError:
    return []
  snapshot = getattr(profiling, "snapshot", None)
  if snapshot is None:
    return []
  series = snapshot().get(name)
  if not series:
    return []
  return [s for s in series["samples"] if not s.profiled and
          (origin is None or s.origin == origin)]


def median_ms(name: str, origin: Optional[str] = None) -> Optional[float]:
  """The median device ms a step (a sample's ms over the steps it
  covers) of the span ``name``."""
  found = samples(name, origin)
  if not found:
    return None
  return statistics.median(s.ms / s.count for s in found)


def idle_share(name: str, origin: Optional[str] = None) -> Optional[float]:
  """100 x the summed device gaps between consecutive spans ``name`` (the
  end of one to the start of the next) over the summed distances between
  their starts, in %; pairs more than ``PAUSE`` times the median
  distance apart are left out."""
  pairs = [(s.gap_ms, s.period_ms) for s in samples(name, origin)
           if s.period_ms]
  if not pairs:
    return None
  typical = statistics.median(p for _, p in pairs)
  kept = [(g, p) for g, p in pairs if p <= PAUSE * typical]
  return 100.0 * sum(g for g, _ in kept) / sum(p for _, p in kept)
