"""Seconds to build the scene batch (``BatchedEnv(...)``: towns, routes,
spawns, the initial state on the card), on the host clock, ending in a
device synchronise."""


def read(ctx):
  return ctx.get("host", {}).get("env_build_s")
