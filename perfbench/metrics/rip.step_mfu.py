"""The whole closed-loop step's share of the card's float32 peak, in %:
the RIP ensemble's model FLOPs of one step over all scenes
(``counts/rip_flops``: the K encoder and merger forwards and the plan's
forward and backward passes through the K flow priors, from the
reference's shapes) over the unprofiled window's mean step time times 67
TFLOP/s (float32 outside the tensor cores: the configuration runs IEEE
float32 with TF32 off)."""

from perfbench.counts import peaks


def read(ctx):
  if ctx.get("step_flops") is None:
    return None
  seconds = ctx["step_ms"] / 1e3
  return 100.0 * ctx["step_flops"] / (seconds * peaks.FP32_FLOPS_PER_S)
