"""Device ms of the training update's optimiser step (accumulation,
clip, Adam), in the program's device marks of the span
``update.optimizer``; the median over the updates run with no profiler
(the window and the set-up's first updates: the median is robust to the
latter)."""

from perfbench import marks


def read(ctx):
  del ctx
  return marks.median_ms("update.optimizer")
