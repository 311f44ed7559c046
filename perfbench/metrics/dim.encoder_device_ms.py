"""Device ms a step of the DIM policy's context encoder (MobileNetV2 and
the merger), in the eager pass's ``dim.encode`` spans."""


def read(ctx):
  us = ctx["eager"].span_device_us("dim.encode") if "eager" in ctx else None
  return None if us is None else us / 1e3 / ctx["eager_steps"]
