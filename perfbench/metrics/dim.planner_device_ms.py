"""Device ms a step of the DIM policy's planner (the Adam steps of the
flow, forward and backward, and the decode), in the eager pass's
``dim.plan`` spans."""


def read(ctx):
  us = ctx["eager"].span_device_us("dim.plan") if "eager" in ctx else None
  return None if us is None else us / 1e3 / ctx["eager_steps"]
