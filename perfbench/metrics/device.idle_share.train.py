"""The device's idle share of a training update, in %: 1 less the busy
time an update in the trace of updates back to back (the union of its
device operations) over the unprofiled window's mean update time."""


def read(ctx):
  if "train" not in ctx:
    return None
  busy_ms = ctx["train"].busy_us() / 1e3 / ctx["train_updates"]
  return 100.0 * (1.0 - busy_ms / ctx["update_ms"])
