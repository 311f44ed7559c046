"""The training update's share of the card's float32 peak, in %: the
model FLOPs of one update at the cell's batch (``counts/dim_flops``:
forward, and backward as twice the forward, from the reference's shapes)
over the unprofiled window's mean update time times 67 TFLOP/s (float32
outside the tensor cores: the configuration runs IEEE float32 with TF32
off)."""

from perfbench.counts import peaks


def read(ctx):
  if ctx.get("update_flops") is None:
    return None
  seconds = ctx["update_ms"] / 1e3
  return 100.0 * ctx["update_flops"] / (seconds * peaks.FP32_FLOPS_PER_S)
