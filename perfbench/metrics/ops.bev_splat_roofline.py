"""The BEV splat kernel's share of its roofline, in %: the frozen least
time of one launch on the step's own inputs (``counts/splat.py``) over
the kernel's mean time a launch in the trace of captured replays.  None
where no splat kernel ran."""


def read(ctx):
  if "replay" not in ctx or ctx.get("splat_bound_ms") is None:
    return None
  launches = ctx["replay"].intervals("bev_splat")
  if not launches:
    return None
  mean_ms = sum(b - a for a, b in launches) / len(launches) / 1e3
  return 100.0 * ctx["splat_bound_ms"] / mean_ms
