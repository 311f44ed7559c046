"""Device ms of the world step (dynamics, traffic, events) in a replayed
step, in the program's device marks inside the captured step
(``world_step``), read from the last replay of each rollout call with no
profiler running; the median over the calls (the window and the set-up's
calls after the capture: the median is robust to the latter)."""

from perfbench import marks


def read(ctx):
  del ctx
  return marks.median_ms("world_step", "replay")
