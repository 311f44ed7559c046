"""The trace arithmetic on a made-up trace: busy time as a union of
intervals, device time by span, idle gaps by what the host was doing, and
the readers that turn them into per-layer metrics."""

import types

import torch

from perfbench import registry
from perfbench import trace as trace_lib

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


def _event(name, start, end, device=CUDA):
  return types.SimpleNamespace(
      name=name, device_type=device, is_user_annotation=False,
      time_range=types.SimpleNamespace(start=start, end=end))


class _Prof:

  def __init__(self, events):
    self._events = events

  def events(self):
    return self._events


def _trace():
  return trace_lib.Trace(_Prof([
      _event("perfbench.world_step", 0.0, 100.0, CPU),
      _event("perfbench.bev.splat", 100.0, 200.0, CPU),
      _event("perfbench.world_step", 200.0, 300.0, CPU),
      _event("perfbench.world_step", 0.0, 100.0),  # its GPU-side copy
      _event("k_add", 10.0, 30.0),
      _event("k_mul", 20.0, 40.0),        # overlaps k_add
      _event("bev_splat_kernel", 150.0, 160.0),
      _event("k_add", 250.0, 260.0),
  ]), seconds=300e-6)


def test_merged_is_a_union():
  assert trace_lib.merged([(3, 4), (0, 2), (1, 3)]) == [(0, 4)]
  assert trace_lib.merged([(0, 1), (2, 3)]) == [(0, 1), (2, 3)]


def test_busy_counts_overlap_once_and_leaves_out_spans():
  t = _trace()
  assert t.kernel_count() == 4
  assert t.busy_us() == 30.0 + 10.0 + 10.0


def test_span_device_time_by_start():
  t = _trace()
  assert t.span_device_us("world_step") == 20.0 + 20.0 + 10.0
  assert t.span_device_us("bev.splat") == 10.0
  assert t.span_device_us("dim.plan") is None


def test_idle_gaps_by_host_span():
  gaps = dict(_trace().idle_gaps())
  # 40 -> 150 mostly under bev.splat (midpoint 95 is in world_step);
  # 160 -> 250 midpoint 205 in world_step.
  assert gaps == {"world_step": (110.0 + 90.0) / 1e6}


def test_top_ops_sum_by_name():
  top = _trace().top_ops()
  assert top[0][0] == "k_add" and abs(top[0][1] - 30.0 / 1e6) < 1e-12


def test_readers_on_the_made_up_trace():
  t = _trace()
  ctx = {"eager": t, "eager_steps": 2, "replay": t, "replay_steps": 2,
         "step_ms": 0.1, "splat_bound_ms": 0.005}
  read = lambda name: registry.reader(name).read(ctx)  # pylint: disable=unnecessary-lambda-assignment
  assert read("sim.world_step_device_ms") == 50.0 / 1e3 / 2
  assert read("device.kernels_per_step") == 2.0
  assert abs(read("device.idle_share.rollout") - 75.0) < 1e-9
  assert abs(read("ops.bev_splat_roofline") - 50.0) < 1e-9
  assert read("sim.autopilot_device_ms") is None
  assert read("dim.step_mfu") is None
