"""Device ms of the step's sensor synthesis (the BEV gather, the splat
kernel and the checksum) in a replayed step, in the program's device
marks inside the captured step (``sensors``), read from the last replay
of each rollout call with no profiler running; the median over the calls
(the window and the set-up's calls after the capture: the median is
robust to the latter)."""

from perfbench import marks


def read(ctx):
  del ctx
  return marks.median_ms("sensors", "replay")
