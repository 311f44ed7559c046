"""Device ms of TransFuser's four fusions (each: both maps pooled to 8 x
8 anchors, the GPT over their 128 tokens, the two maps upsampled and
added to the trunks) in a replayed step: the program's four
``transfuser.fuse`` marks inside the captured step (``Encoder.forward``
of ``models/transfuser.py``), summed over the marks of one replay (the
last replay of a rollout call, with no profiler running); the median over
the calls.  Each mark's ms is taken whole: its count is the GPT's blocks,
not steps."""

import statistics
from collections import defaultdict

from perfbench import marks


def read(ctx):
  del ctx
  by_step = defaultdict(float)
  for s in marks.samples("transfuser.fuse", "replay"):
    by_step[s.index] += s.ms
  return statistics.median(by_step.values()) if by_step else None
