"""Device ms of the training update's forward pass, to the loss, in the
program's device marks of the span ``update.forward``; the median over
the updates run with no profiler (the window and the set-up's first
updates: the median is robust to the latter)."""

from perfbench import marks


def read(ctx):
  del ctx
  return marks.median_ms("update.forward")
