"""The frozen yardsticks against sums worked by hand at a small size."""

import torch
from torch import nn
from torch.utils.flop_counter import FlopCounterMode

from perfbench.counts import dim_flops, peaks, splat


def test_splat_bytes_and_ops_by_hand():
  # 2 scenes; hero [2, 4], 3 wall, 2 road and 1 box slots of 6 values.
  values = 2 * 4 + 2 * (3 + 2 + 1) * 6
  assert splat.splat_bytes(2, values) == (
      values * 4 + (200 + 2 * 200 * 200) * 4 + 2 * 200 * 200 * 2 * 4)
  assert splat.splat_ops(5) == 200 * 200 * 5 * 10
  ms, by = splat.bound_ms(2, values, 5)
  assert by == "bytes"
  assert ms == 1e3 * splat.splat_bytes(2, values) / peaks.HBM_BYTES_PER_S


def test_splat_bound_of_inputs_counts_live_slots():
  hero = torch.zeros(2, 4)
  walls = torch.zeros(2, 3, 6)
  walls[0, :2, 2] = 1.0  # two live walls in scene 0
  roads = torch.zeros(2, 2, 6)
  roads[1, 0, 2] = 3.0   # one live road in scene 1
  boxes = torch.zeros(2, 1, 6)
  ms, _ = splat.bound_ms_of_inputs(hero, walls, roads, boxes)
  assert ms == splat.bound_ms(2, 8 + 72, 3)[0]


def test_flop_counter_by_hand():
  conv = nn.Conv2d(2, 4, 3, padding=1, bias=False, device="meta")
  lin = nn.Linear(5, 7, device="meta")
  with FlopCounterMode(display=False) as counter:
    conv(torch.zeros(3, 2, 10, 10, device="meta"))
    lin(torch.zeros(3, 5, device="meta"))
  # 2 FLOPs a multiply-add: conv 3*4*10*10 outputs of 2*3*3 taps.
  assert counter.get_total_flops() == 2 * (3 * 4 * 100 * 18) + 2 * 3 * 5 * 7


def test_dim_step_flops_scale_with_scenes():
  config = {"input_size": [100, 100], "output_shape": [4, 2],
            "num_plan_steps": 20}
  one = dim_flops.closed_loop_step_flops(config, 1)
  assert dim_flops.closed_loop_step_flops(config, 1024) == 1024 * one
  # The MobileNetV2 encoder at 100 x 100 x 2 is ~150 MFLOP a scene; the
  # 20 plan steps add a few percent.
  assert 150e6 < one < 165e6
