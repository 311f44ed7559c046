"""The device's idle share of a rollout step, in %: 1 less the busy time a
step in the trace of captured replays (the union of its device
operations) over the unprofiled window's mean step time."""


def read(ctx):
  if "replay" not in ctx:
    return None
  busy_ms = ctx["replay"].busy_us() / 1e3 / ctx["replay_steps"]
  return 100.0 * (1.0 - busy_ms / ctx["step_ms"])
