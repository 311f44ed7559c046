"""The whole closed-loop step's share of the card's float32 peak, in %:
TransFuser's model FLOPs of one step over all scenes
(``counts/transfuser_flops``: both trunks' convolutions, the four GPTs'
matrix products and attention, the join MLP and the GRU, from the
reference's shapes; 23.26 GFLOP a scene) over the unprofiled window's
mean step time times 67 TFLOP/s (float32 outside the tensor cores: the
configuration runs IEEE float32 with TF32 off)."""

from perfbench.counts import peaks


def read(ctx):
  if ctx.get("step_flops") is None:
    return None
  seconds = ctx["step_ms"] / 1e3
  return 100.0 * ctx["step_flops"] / (seconds * peaks.FP32_FLOPS_PER_S)
