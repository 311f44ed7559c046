"""Device ms a step of the operations that ``sim.autopilot_policy``
launches, in the eager pass's ``autopilot`` spans."""


def read(ctx):
  us = ctx["eager"].span_device_us("autopilot") if "eager" in ctx else None
  return None if us is None else us / 1e3 / ctx["eager_steps"]
