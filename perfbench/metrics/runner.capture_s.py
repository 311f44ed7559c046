"""Seconds of the warm-up chunks, on the host clock: the step runner's
eager warm-up steps and its CUDA-graph capture, ending in a fetch."""


def read(ctx):
  return ctx.get("host", {}).get("capture_s")
