"""Device ms of the RIP policy's K context encoders (MobileNetV2 and the
merger of each member, in turn) in a replayed step: the program's
``rip.encode`` mark inside the captured step (``RipPolicy.__call__``),
read from the last replay of each rollout call with no profiler running;
the median over the calls (the window and the set-up's calls after the
capture: the median is robust to the latter).  The mark's ms is taken
whole: its count is the members encoded, not steps."""

import statistics

from perfbench import marks


def read(ctx):
  del ctx
  found = marks.samples("rip.encode", "replay")
  return statistics.median(s.ms for s in found) if found else None
