"""Device ms a replayed step of the step runner: the program's
``rollout.issue`` marks (before the first replay of a rollout call and
after its last, on the device clock) over the call's steps; the median
over the calls whose steps were all replays, with no profiler running
(the window and the set-up's calls after the capture: the median is
robust to the latter)."""

from perfbench import marks


def read(ctx):
  del ctx
  return marks.median_ms("rollout.issue", "replay")
