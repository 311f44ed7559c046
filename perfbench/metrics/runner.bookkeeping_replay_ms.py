"""Device ms of the step's bookkeeping (done flags, episode stats, auto-
reset and the copy into the live state) in a replayed step, in the
program's device marks inside the captured step (``bookkeeping``), read
from the last replay of each rollout call with no profiler running; the
median over the calls (the window and the set-up's calls after the
capture: the median is robust to the latter)."""

from perfbench import marks


def read(ctx):
  del ctx
  return marks.median_ms("bookkeeping", "replay")
