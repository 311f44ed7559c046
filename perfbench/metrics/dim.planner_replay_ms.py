"""Device ms of the DIM policy's planner (the Adam steps of the flow and
the decode) in a replayed step, in the program's device marks inside the
captured step (``dim.plan``), read from the last replay of each rollout
call with no profiler running; the median over the calls (the window and
the set-up's calls after the capture: the median is robust to the
latter)."""

from perfbench import marks


def read(ctx):
  del ctx
  return marks.median_ms("dim.plan", "replay")
