"""Device ms a batch of the loader's device gather (``index_select`` of
the resident pack, uint8 LIDAR included), in the ``loader.gather`` spans
of a profiled pass over the trainer's own loader."""


def read(ctx):
  us = ctx["gather"].span_device_us("loader.gather") if "gather" in ctx \
      else None
  return None if us is None else us / 1e3 / ctx["gather_batches"]
