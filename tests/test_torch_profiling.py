"""The port's ``utils/profiling`` against the JAX package's on the CPU:
``Meter``'s rates under the same fake clock, ``timed``'s result and
seconds, and ``trace``'s file; and the port's own spans, marks and
registry (the rollout's, the DIM policy's, the update's and the loader's
spans), the benchmark's readers of that registry over made-up samples,
and ``device_busy``'s arithmetic over made-up events."""

import dataclasses
import json
import os
import time
import types

import jax
import pytest
import torch

from oatomobile_torch.utils import profiling as tprof
from oatomobile_tpu.utils import profiling as jprof
from test_torch_compiled import fake_card  # pylint: disable=unused-import


class FakeClock:
  """A ``time.perf_counter`` that returns the given instants in turn."""

  def __init__(self, instants):
    self._instants = iter(instants)

  def __call__(self):
    return next(self._instants)


# (start, then one instant per update) and the steps of each update.
INSTANTS = (10.0, 10.5, 10.75, 12.0, 12.0, 13.5)
STEPS = (512, 1024, 256, 128, 4096)


@pytest.mark.parametrize("ema", [0.9, 0.5, 0.0])
@pytest.mark.parametrize("start", [True, False], ids=["start", "no_start"])
def test_meter_matches_jax(monkeypatch, ema, start):
  rates = {}
  for name, module in (("jax", jprof), ("torch", tprof)):
    monkeypatch.setattr(time, "perf_counter", FakeClock(INSTANTS))
    meter = module.Meter(ema=ema)
    if start:
      meter.start()
    returned = [meter.update(n) for n in STEPS]
    rates[name] = (returned, meter.steps_per_sec, meter.total_steps,
                   meter.steps_per_sec_per_chip)
  (want, want_rate, want_total, want_chip), (got, rate, total, chip) = (
      rates["jax"], rates["torch"])
  assert got == want
  assert rate == want_rate and total == want_total
  assert rate > 0.0
  # Per chip: the JAX package divides by its devices (the tests' 8 CPU
  # devices), the port by its cards (the CPU counts as one).
  assert want_chip == want_rate / jax.device_count()
  assert chip == rate / tprof.num_cards() == rate


def test_meter_is_zero_before_a_rate():
  meter = tprof.Meter()
  assert meter.steps_per_sec == 0.0 and meter.steps_per_sec_per_chip == 0.0
  assert meter.update(7) == 0.0  # the first update only starts the clock
  assert meter.total_steps == 0


@dataclasses.dataclass
class _Out:
  label: str
  value: torch.Tensor


@pytest.mark.parametrize("kind", ["tensor", "tuple", "dict", "dataclass"])
def test_timed_returns_the_result_and_seconds(kind):
  x = torch.arange(6.0)

  def compute(v, scale=1.0):
    y = v * scale
    return {"tensor": y, "tuple": ((), y), "dict": {"y": y},
            "dataclass": _Out("y", y)}[kind]

  result, seconds = tprof.timed(compute, x, scale=2.0)
  y = {"tensor": lambda r: r, "tuple": lambda r: r[1],
       "dict": lambda r: r["y"], "dataclass": lambda r: r.value}[kind](result)
  assert torch.equal(y, x * 2.0)
  assert seconds > 0.0
  _, jseconds = jprof.timed(lambda v: v * 2.0, x.numpy())
  assert jseconds > 0.0


def test_timed_fetches_what_it_is_told():
  fetched = []

  def fetch(result):
    fetched.append(result)
    return result[1]

  result, seconds = tprof.timed(lambda: ("label", torch.ones(2)),
                                fetch=fetch)
  assert fetched == [result] and seconds > 0.0


def test_trace_writes_a_chrome_trace(tmp_path):
  log_dir = str(tmp_path / "trace")
  with tprof.trace(log_dir) as prof:
    torch.randn(64, 64).matmul(torch.randn(64, 64)).sum()
  path = os.path.join(log_dir, tprof.TRACE_FILE)
  with open(path) as fp:
    events = json.load(fp)["traceEvents"]
  names = {e.get("name", "") for e in events}
  assert any("matmul" in n or "mm" in n for n in names), sorted(names)[:20]
  assert prof.events()


def test_trace_writes_its_file_when_the_block_raises(tmp_path):
  log_dir = str(tmp_path / "trace")
  with pytest.raises(ValueError):
    with tprof.trace(log_dir):
      torch.ones(3).sum()
      raise ValueError("stop")
  assert os.path.exists(os.path.join(log_dir, tprof.TRACE_FILE))


# -- the program's spans, marks and registry ----------------------------------


@pytest.fixture
def registry():
  """An empty registry before and after the test."""
  tprof.reset()
  yield tprof
  tprof.reset()


def _samples(name):
  return tprof.snapshot().get(name, {"samples": []})["samples"]


def test_the_registry_bounds_its_samples_per_name(registry, monkeypatch):
  monkeypatch.setattr(tprof, "SAMPLES_PER_NAME", 5)
  for _ in range(8):
    with tprof.span("block", "cpu"):
      pass
  series = tprof.snapshot()["block"]
  assert series["count"] == 8 and len(series["samples"]) == 5
  assert series["sum_ms"] >= sum(s.ms for s in series["samples"]) >= 0.0
  # The last samples are kept: each block is a root, counted in turn.
  assert [s.index for s in series["samples"]] == [3, 4, 5, 6, 7]
  tprof.reset()
  assert tprof.snapshot() == {}


def test_samples_flag_the_profiler_and_what_ran(registry):
  from torch.profiler import ProfilerActivity, profile  # pylint: disable=import-outside-toplevel
  with tprof.span("outer", "cpu"):
    with tprof.span("inner", "cpu"):
      pass
  with profile(activities=[ProfilerActivity.CPU]):
    with tprof.span("outer", "cpu"):
      pass
  with tprof.running("replay"):
    with tprof.span("outer", "cpu"):
      pass
  with tprof.span("outer", "cpu"):
    with tprof.running("capture"):
      pass
  outer = _samples("outer")
  assert [s.profiled for s in outer] == [False, True, False, False]
  assert [s.origin for s in outer] == ["eager", "eager", "replay",
                                       "capture"]
  (inner,) = _samples("inner")
  assert inner.parent == "outer" and inner.index == 0
  assert outer[0].parent is None and outer[0].gap_ms is None
  # From the second on: the end and the start of the one before.
  assert all(0.0 <= s.gap_ms <= s.period_ms for s in outer[1:])


def test_consecutive_spans_share_their_marks(registry, monkeypatch):
  clock = iter(float(t) for t in range(100))
  monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
  with tprof.span("parent"):
    with tprof.span("a", "cpu"):  # marks 0 and 1
      pass
    with tprof.span("b", "cpu"):  # starts at a's end: mark 2
      pass
    with tprof.span("host"):  # no marks: the next starts anew
      pass
    with tprof.span("c", "cpu"):  # marks 3 and 4
      pass
  assert [_samples(n)[0].ms for n in "abc"] == [1e3, 1e3, 1e3]


def test_gaps_are_taken_between_spans_on_one_device(registry):
  # A card's marks are events and the CPU's are clock readings: a gap
  # between the two cannot be read.
  for device in ("cpu", "meta", "cpu", "meta"):
    with tprof.span("block", device):
      pass
  gaps = [s.gap_ms for s in _samples("block")]
  assert gaps[:2] == [None, None] and None not in gaps[2:]


def test_a_span_that_raises_is_not_marked(registry):
  with pytest.raises(ValueError):
    with tprof.span("fails", "cpu"):
      raise ValueError("stop")
  assert "fails" not in tprof.snapshot()
  with tprof.span("after", "cpu"):
    pass
  assert _samples("after")[0].parent is None


def test_host_spans_open_only_under_a_profiler(registry, monkeypatch):
  from torch.profiler import ProfilerActivity, profile  # pylint: disable=import-outside-toplevel
  opened = []
  real = torch.profiler.record_function

  def recording(name):
    opened.append(name)
    return real(name)

  monkeypatch.setattr(torch.profiler, "record_function", recording)
  with tprof.span("rollout.issue", "cpu"):
    torch.ones(4).sum()
  assert not opened
  with profile(activities=[ProfilerActivity.CPU]) as prof:
    with tprof.span("rollout.issue", "cpu"):
      torch.ones(4).sum()
  assert opened == ["oatomobile.rollout.issue"]
  assert "oatomobile.rollout.issue" in {e.name for e in prof.events()}


def _make_dim_policy():
  from oatomobile_torch.baselines.learned.dim.policy import make_dim_policy  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.models import ImitativeModel  # pylint: disable=import-outside-toplevel
  model = ImitativeModel((4, 2), (16, 16),
                         generator=torch.Generator().manual_seed(0),
                         device="cpu")
  return make_dim_policy(model, num_plan_steps=2)


STEP_MARKS = {
    "autopilot": ("autopilot", "world_step", "sensors", "bookkeeping"),
    "dim": ("dim.observe", "dim.encode", "dim.plan", "dim.act",
            "world_step", "bookkeeping"),
}


@pytest.mark.parametrize("policy", sorted(STEP_MARKS))
def test_a_rollout_marks_each_part_of_each_step(registry, policy):
  from oatomobile_torch.envs.batched import BatchedEnv  # pylint: disable=import-outside-toplevel
  env = BatchedEnv("Town02", 2, num_vehicles=2, device="cpu")
  kwargs = ({"compute": ("lidar",)} if policy == "autopilot" else
            {"policy": _make_dim_policy()})
  for steps in (3, 2):
    env.rollout(steps, **kwargs)
  snap = tprof.snapshot()
  assert set(snap) == set(STEP_MARKS[policy]) | {"rollout.issue"}
  for name in STEP_MARKS[policy]:
    samples = snap[name]["samples"]
    assert [s.index for s in samples] == [0, 0, 0, 1, 1]
    assert all(s.parent == "step" and s.origin == "eager" and s.ms >= 0.0
               for s in samples)
  issues = snap["rollout.issue"]["samples"]
  assert [(s.index, s.count, s.parent) for s in issues] == [
      (0, 3, "rollout.chunk"), (1, 2, "rollout.chunk")]
  # The parts of a step lie inside its call's marks.
  per_call = [sum(snap[n]["samples"][i].ms for n in STEP_MARKS[policy]
                  for i in idx) for idx in ((0, 1, 2), (3, 4))]
  assert all(parts <= s.ms for parts, s in zip(per_call, issues))


def test_a_captured_rollout_tells_warm_up_capture_and_replays(registry,
                                                              fake_card):
  from oatomobile_torch.envs.batched import BatchedEnv  # pylint: disable=import-outside-toplevel
  env = BatchedEnv("Town02", 2, num_vehicles=2, device="cpu")
  env.rollout(4)
  env.rollout(2)
  assert len(fake_card) == 1
  # Two eager warm-up steps, then the capture's run (the third step's
  # replay runs nothing on the fake card: the capture's run stands for
  # it), then three replays.
  assert [s.origin for s in _samples("world_step")] == [
      "eager", "eager", "capture", "replay", "replay", "replay"]
  assert [s.origin for s in _samples("rollout.issue")] == ["capture",
                                                           "replay"]


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_an_update_marks_its_three_phases(registry, grad_accum):
  from oatomobile_torch import rng as rng_lib  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.parallel import dp  # pylint: disable=import-outside-toplevel
  model = torch.nn.Linear(3, 1)
  state = dp.TrainState.create(model, dp.adam(model, 1e-2),
                               rng_lib.PRNGKey(0, "cpu"))

  def loss_fn(m, batch, rng):
    del rng
    return ((m(batch["x"]) - batch["y"]) ** 2).mean()

  update = dp.make_update_fn(loss_fn, clip_norm=1.0, grad_accum=grad_accum)
  batch = {"x": torch.randn(8, 3), "y": torch.randn(8, 1)}
  for _ in range(4):
    state, loss = update(state, batch)
  assert torch.isfinite(loss)
  snap = tprof.snapshot()
  assert set(snap) == {"update", "update.forward", "update.backward",
                       "update.optimizer"}
  for name in ("update.forward", "update.backward", "update.optimizer"):
    assert [(s.parent, s.index) for s in snap[name]["samples"]] == [
        ("update", i) for i in range(4)]
  updates = snap["update"]["samples"]
  assert [s.index for s in updates] == [0, 1, 2, 3]
  assert updates[0].gap_ms is None
  assert all(s.gap_ms is not None and s.period_ms >= s.gap_ms
             for s in updates[1:])


def test_the_loader_gather_is_a_host_span(registry, monkeypatch):
  from oatomobile_torch.datasets.carla import CARLADataset  # pylint: disable=import-outside-toplevel
  import numpy as np  # pylint: disable=import-outside-toplevel
  opened = []
  monkeypatch.setattr(tprof, "_profiling", lambda: True)
  real = torch.profiler.record_function
  monkeypatch.setattr(torch.profiler, "record_function",
                      lambda name: opened.append(name) or real(name))
  data = {"x": torch.arange(12.0).reshape(6, 2)}
  batches = list(CARLADataset.iter_device_batches(data, np.arange(6), 2,
                                                  shuffle=False))
  assert len(batches) == 3 and opened == ["oatomobile.loader.gather"] * 3
  assert tprof.snapshot() == {}  # a host span takes no marks


# -- the benchmark's readers of the registry ----------------------------------


def _sample(name, ms, profiled=False, origin="replay", count=1, gap=None,
            period=None, index=0):
  return tprof.Sample(name, "step", index, profiled, origin, ms, count,
                      gap, period)


# metric -> (span it reads, samples, value read).
READERS = {
    "runner.replay_device_ms": ("rollout.issue", [
        _sample("rollout.issue", 32.0, count=16),
        _sample("rollout.issue", 48.0, count=16),
        _sample("rollout.issue", 64.0, count=16),
        _sample("rollout.issue", 640.0, count=16, profiled=True),
        _sample("rollout.issue", 640.0, count=16, origin="capture"),
    ], 3.0),
    "sim.world_step_replay_ms": ("world_step", [
        _sample("world_step", 1.0), _sample("world_step", 2.0),
        _sample("world_step", 9.0, profiled=True)], 1.5),
    "sim.autopilot_replay_ms": ("autopilot", [
        _sample("autopilot", 0.8), _sample("autopilot", 7.0, origin="eager"),
        _sample("autopilot", 9.0, profiled=True)], 0.8),
    "sensors.lidar_replay_ms": ("sensors", [
        _sample("sensors", 0.2), _sample("sensors", 0.3),
        _sample("sensors", 0.4), _sample("sensors", 5.0, profiled=True)],
                                0.3),
    "runner.bookkeeping_replay_ms": ("bookkeeping", [
        _sample("bookkeeping", 0.25),
        _sample("bookkeeping", 3.0, profiled=True)], 0.25),
    "dim.encoder_replay_ms": ("dim.encode", [
        _sample("dim.encode", 29.0), _sample("dim.encode", 31.0),
        _sample("dim.encode", 90.0, profiled=True)], 30.0),
    "dim.planner_replay_ms": ("dim.plan", [
        _sample("dim.plan", 16.5), _sample("dim.plan", 90.0, profiled=True)],
                              16.5),
    "rip.encoder_replay_ms": ("rip.encode", [
        _sample("rip.encode", 115.0, count=4),
        _sample("rip.encode", 117.0, count=4),
        _sample("rip.encode", 300.0, count=4, profiled=True)], 116.0),
    "rip.planner_replay_ms": ("rip.plan", [
        _sample("rip.plan", 21.0, count=40),
        _sample("rip.plan", 90.0, count=40, profiled=True)], 21.0),
    "transfuser.observe_replay_ms": ("transfuser.observe", [
        _sample("transfuser.observe", 7.7), _sample("transfuser.observe", 7.9),
        _sample("transfuser.observe", 50.0, profiled=True)], 7.8),
    "transfuser.encoder_replay_ms": ("transfuser.encode", [
        _sample("transfuser.encode", 296.0, count=4),
        _sample("transfuser.encode", 298.0, count=4),
        _sample("transfuser.encode", 900.0, count=4, profiled=True)], 297.0),
    # Four marks a replayed step, summed by step (150 and 160 ms); a
    # profiled step and an eager mark left out.
    "transfuser.fusion_replay_ms": ("transfuser.fuse", [
        _sample("transfuser.fuse", ms, count=8, index=i)
        for i, step in enumerate(((10.0, 20.0, 40.0, 80.0),
                                  (12.0, 22.0, 42.0, 84.0)))
        for ms in step] + [
            _sample("transfuser.fuse", 500.0, count=8, index=2,
                    profiled=True),
            _sample("transfuser.fuse", 70.0, count=8, index=3,
                    origin="eager")], 155.0),
    "train.forward_device_ms": ("update.forward", [
        _sample("update.forward", 20.0, origin="eager"),
        _sample("update.forward", 22.0, origin="eager"),
        _sample("update.forward", 80.0, origin="eager", profiled=True)],
                                21.0),
    "train.backward_device_ms": ("update.backward", [
        _sample("update.backward", 35.0, origin="eager"),
        _sample("update.backward", 70.0, origin="eager", profiled=True)],
                                 35.0),
    "train.optimizer_device_ms": ("update.optimizer", [
        _sample("update.optimizer", 4.0, origin="eager"),
        _sample("update.optimizer", 6.0, origin="eager"),
        _sample("update.optimizer", 8.0, origin="eager"),
        _sample("update.optimizer", 1.0, origin="eager", profiled=True)],
                                  6.0),
    # Gaps of 1 and 3 ms in distances of 50 ms; a set-up pause (2 s) and
    # a profiled pair left out.
    "device.idle_share.rollout_window": ("rollout.issue", [
        _sample("rollout.issue", 49.0, count=16),
        _sample("rollout.issue", 49.0, count=16, gap=2000.0, period=2049.0),
        _sample("rollout.issue", 49.0, count=16, gap=1.0, period=50.0),
        _sample("rollout.issue", 47.0, count=16, gap=3.0, period=50.0),
        _sample("rollout.issue", 49.0, count=16, gap=3.0, period=50.0),
        _sample("rollout.issue", 49.0, count=16, gap=30.0, period=80.0,
                profiled=True),
    ], 100.0 * 7.0 / 150.0),
    "device.idle_share.train_window": ("update", [
        _sample("update", 60.0, origin="eager", gap=0.5, period=61.0),
        _sample("update", 60.0, origin="eager", gap=1.5, period=61.0),
        _sample("update", 60.0, origin="eager", gap=9.0, period=69.0,
                profiled=True),
    ], 100.0 * 2.0 / 122.0),
}


def _reader(name):
  from perfbench import registry as bench_registry  # pylint: disable=import-outside-toplevel
  return bench_registry.reader(name)


@pytest.mark.parametrize("metric", sorted(READERS))
def test_a_reader_reads_the_registry_and_skips_profiled_samples(
    metric, monkeypatch):
  span, samples, want = READERS[metric]
  snap = {span: {"count": len(samples), "sum_ms": sum(s.ms for s in samples),
                 "samples": samples},
          "other": {"count": 1, "sum_ms": 1.0,
                    "samples": [_sample("other", 1.0)]}}
  monkeypatch.setattr(tprof, "snapshot", lambda: snap)
  assert _reader(metric).read({}) == pytest.approx(want)
  monkeypatch.setattr(tprof, "snapshot", lambda: {
      span: {"count": 1, "sum_ms": 1.0,
             "samples": [s._replace(profiled=True) for s in samples]}})
  assert _reader(metric).read({}) is None


@pytest.mark.parametrize("metric", sorted(READERS))
def test_a_reader_finds_nothing_in_a_program_without_a_registry(
    metric, monkeypatch):
  monkeypatch.delattr(tprof, "snapshot")
  assert _reader(metric).read({}) is None


def test_every_reader_is_in_the_benchmark():
  from perfbench import registry as bench_registry  # pylint: disable=import-outside-toplevel
  rows = {m["name"]: m for m in bench_registry.benchmark()["per_layer"]
          if m["source"] == "program_span"}
  assert set(rows) == set(READERS)


# -- device_busy: busy as the union of device operations ----------------------


def _event(name, start, end, device=True):
  kind = (torch.autograd.DeviceType.CUDA if device else
          torch.autograd.DeviceType.CPU)
  return types.SimpleNamespace(name=name, device_type=kind,
                               time_range=types.SimpleNamespace(
                                   start=start, end=end))


def test_device_busy_counts_overlapping_operations_once():
  events = [
      _event("gemm", 0.0, 1000.0),
      _event("copy", 500.0, 1500.0),  # overlaps the gemm by 500 us
      _event("fill", 3000.0, 3500.0),
      _event("oatomobile.rollout.issue", 0.0, 9000.0),  # a span's device side
      _event("cpu_op", 0.0, 9000.0, device=False),
  ]
  got = tprof.busy_of_events(events, steps=2, step_ms=2.0)
  assert got["device_busy_ms_per_step"] == pytest.approx(1.0)  # 2 ms / 2
  assert got["kernels_per_step"] == pytest.approx(1.5)
  assert got["idle_share"] == pytest.approx(0.5)
  assert tprof.busy_of_events([], 1, 1.0)["device_busy_ms_per_step"] == 0.0
