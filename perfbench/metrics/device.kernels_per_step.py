"""Device operations (kernels, copies, fills) a step in the trace of
captured replays."""


def read(ctx):
  if "replay" not in ctx:
    return None
  return ctx["replay"].kernel_count() / ctx["replay_steps"]
