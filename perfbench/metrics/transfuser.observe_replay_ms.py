"""Device ms of the TransFuser policy's observation (the front camera's
ray cast, the BEV splat, the state and goal sensors, the camera's crop
and both resizes to 256 x 256) in a replayed step: the program's
``transfuser.observe`` mark inside the captured step
(``TransFuserPolicy.__call__``), read from the last replay of each rollout
call with no profiler running; the median over the calls (the window and
the set-up's calls after the capture: the median is robust to the
latter)."""

import statistics

from perfbench import marks


def read(ctx):
  del ctx
  found = marks.samples("transfuser.observe", "replay")
  return statistics.median(s.ms for s in found) if found else None
