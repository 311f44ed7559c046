"""Device ms a step of the operations that ``sim.world_step`` launches
(dynamics, traffic, events), in the eager pass's ``world_step`` spans."""


def read(ctx):
  us = ctx["eager"].span_device_us("world_step") if "eager" in ctx else None
  return None if us is None else us / 1e3 / ctx["eager_steps"]
