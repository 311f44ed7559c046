"""Device ms of the RIP policy's plan (``num_plan_steps`` Adam steps of
the shared plan, each through the K members' flow priors forward and
backward, and the best iterate's decode) in a replayed step: the
program's ``rip.plan`` mark inside the captured step
(``RipPolicy.__call__``), read from the last replay of each rollout call
with no profiler running; the median over the calls.  The mark's ms is
taken whole: its count is the member priors evaluated, not steps."""

import statistics

from perfbench import marks


def read(ctx):
  del ctx
  found = marks.samples("rip.plan", "replay")
  return statistics.median(s.ms for s in found) if found else None
