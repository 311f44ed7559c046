"""Device busy ms an update (the union of its device operations) in a
trace of the trainer's updates back to back."""


def read(ctx):
  if "train" not in ctx:
    return None
  return ctx["train"].busy_us() / 1e3 / ctx["train_updates"]
