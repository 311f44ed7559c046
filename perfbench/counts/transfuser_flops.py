"""TransFuser's model FLOPs, counted from the frozen reference's shapes
(its modules on the ``meta`` device under ``torch.utils.flop_counter``:
two operations a multiply-add of every matrix product and convolution,
nothing of the elementwise work, BatchNorm, pooling, interpolation or
softmax), as ``dim_flops`` counts the DIM's.  Never from the program's
code: a change to the program cannot move it.
"""

import functools

import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.reference.models.transfuser import TransFuser


@functools.lru_cache(maxsize=None)
def flops_per_scene(size: int = 256) -> int:
  """One forward of one scene: both trunks, the four GPTs, the join MLP
  and the GRU's four steps."""
  model = TransFuser(device="meta").eval()
  with FlopCounterMode(display=False) as counter, torch.no_grad():
    model(torch.zeros(1, 3, size, size, device="meta"),
          torch.zeros(1, 2, size, size, device="meta"),
          torch.zeros(1, device="meta"), torch.zeros(1, 2, device="meta"))
  return counter.get_total_flops()


def closed_loop_step_flops(config, scenes: int) -> int:
  """One closed-loop step of the TransFuser policy over ``scenes``: one
  forward a scene."""
  return flops_per_scene(int(config["image"]["size"][0])) * scenes
