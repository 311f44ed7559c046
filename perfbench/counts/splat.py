"""The BEV splat's yardstick: the least time one launch could take on the
card, from the launch's own inputs.

Bytes: every input read once (hero, wall, road and box slots, and the
kernel's tables: 200 pixel centres and the two 200 x 200 constant images)
and the [B, 200, 200, 2] float32 output written once.  Operations: each
pixel tested against each live slot (half-length > 0) of its scene, 10
float32 operations a test; empty slots are skipped.  The least time is the
larger of bytes over the memory rate and operations over the float32
rate.  Frozen: a change to the program cannot move it.
"""

from perfbench.counts import peaks

BEV = 200
OPS_PER_TEST = 10
TABLE_BYTES = (BEV + 2 * BEV * BEV) * 4


def splat_bytes(batch: int, slots_in: int) -> int:
  """Bytes read and written by one launch over ``batch`` scenes with
  ``slots_in`` float32 input values (hero and the three slot arrays)."""
  return slots_in * 4 + TABLE_BYTES + batch * BEV * BEV * 2 * 4


def splat_ops(live_slots: int) -> int:
  return BEV * BEV * live_slots * OPS_PER_TEST


def bound_ms(batch: int, input_values: int, live_slots: int):
  """(least ms, "bytes" or "operations")."""
  bytes_ms = 1e3 * splat_bytes(batch, input_values) / peaks.HBM_BYTES_PER_S
  ops_ms = 1e3 * splat_ops(live_slots) / peaks.FP32_FLOPS_PER_S
  return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                 else "operations")


def bound_ms_of_inputs(hero, walls, roads, boxes):
  """``bound_ms`` of the kernel's input tensors (``bev.gather_inputs``)."""
  values = sum(x.numel() for x in (hero, walls, roads, boxes))
  live = int(sum(int((x[..., 2] > 0).sum()) for x in (walls, roads, boxes)))
  return bound_ms(hero.shape[0], values, live)
