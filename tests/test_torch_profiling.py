"""The port's ``utils/profiling`` against the JAX package's on the CPU:
``Meter``'s rates under the same fake clock, ``timed``'s result and
seconds, and ``trace``'s file."""

import dataclasses
import json
import os
import time

import jax
import pytest
import torch

from oatomobile_torch.utils import profiling as tprof
from oatomobile_tpu.utils import profiling as jprof


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
