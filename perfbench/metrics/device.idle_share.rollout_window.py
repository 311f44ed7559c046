"""The device's idle share between rollout calls, in %: the device gaps
from one call's ``rollout.issue`` end mark to the next call's start
mark, summed, over the summed distances between their start marks, for
calls with no profiler running that replayed only. A gap holds the
call's gather of its returns and the host's fetch of its stats. The set-
up's pauses (the capture, the host-card copies before the window) are
left out as pairs more than ten times the median distance apart."""

from perfbench import marks


def read(ctx):
  del ctx
  return marks.idle_share("rollout.issue", "replay")
