"""Device ms of TransFuser's encoder (both ResNet trunks with the four
fusion transformers, pooled and summed) in a replayed step: the
program's ``transfuser.encode`` mark inside the captured step
(``TransFuserPolicy.__call__``), read from the last replay of each
rollout call with no profiler running; the median over the calls.  The
mark's ms is taken whole: its count is the fusion stages, not steps."""

import statistics

from perfbench import marks


def read(ctx):
  del ctx
  found = marks.samples("transfuser.encode", "replay")
  return statistics.median(s.ms for s in found) if found else None
