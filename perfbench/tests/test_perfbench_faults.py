"""A run with the timed path broken underneath comes out not correct: the
harness's run on the CPU at a small size (its look for a card skipped),
with a fault planted in the program, and with the control (the
reference in the configuration's next lower precision) in the program's
place."""

import time

import pytest
import torch

from perfbench import registry
from perfbench.check import failed

SMALL = {"scenes": 4, "check_within": 2}


def _run(name, control=False, seconds=0.5):
  cell = registry.cell(name, registry.benchmark())
  return registry.driver(cell["traffic"]["driver"]).run(
      cell, seed=2**31 + 99, seconds=seconds, trace=False, control=control,
      device="cpu", process_start=time.perf_counter(), overrides=SMALL)


def _unchanged(step):
  del step
  return lambda params, state, action: state


def _half_batch(step):
  from oatomobile_torch.sim.types import map_state  # pylint: disable=import-outside-toplevel

  def broken(params, state, action):
    new = step(params, state, action)
    half = state.batch_size // 2

    def keep_half(a, b):
      out = a.clone()
      out[half:] = b[half:]
      return out

    return map_state(keep_half, new, state)

  return broken


def _altered(step):
  def broken(params, state, action):
    new = step(params, state, action)
    xy = new.hero_xy.clone()
    xy[0, 0] += 1.0  # one scene's hero a metre off
    return new.replace(hero_xy=xy)

  return broken


CELLS = ("autopilot-town01-b1024-lidar", "dim-town01-b1024")


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered])
@pytest.mark.parametrize("name", CELLS)
def test_a_planted_fault_is_not_correct(monkeypatch, name, fault):
  from oatomobile_torch.envs import batched  # pylint: disable=import-outside-toplevel
  monkeypatch.setattr(batched, "world_step", fault(batched.world_step))
  assert failed(_run(name).checks) > 0


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
  assert failed(_run(name).checks) == 0


def test_the_bfloat16_control_is_not_correct():
  assert failed(_run("autopilot-town01-b1024-lidar", control=True).checks)


@pytest.mark.cuda
def test_the_tf32_control_is_not_correct_on_the_card(cuda_device):
  """As the limits were measured: the cell's own size and a 3 s window
  (with 1 s and chunks from the window's first two the control stayed
  within the limit)."""
  cell = registry.cell("dim-town01-b1024", registry.benchmark())
  result = registry.driver("rollout").run(
      cell, seed=3000000003, seconds=3.0, trace=False, control=True,
      device=cuda_device, process_start=time.perf_counter())
  assert failed(result.checks) > 0


@pytest.fixture
def cuda_device():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card: TF32 exists only there")
  return "cuda"


TRAIN_SMALL = {"samples": 256, "batch": 16}


def _train(control=False):
  cell = registry.cell("dim-train-b512", registry.benchmark())
  return registry.driver("train").run(
      cell, seed=2**31 + 97, seconds=0.5, trace=False, control=control,
      device="cpu", process_start=time.perf_counter(),
      overrides=TRAIN_SMALL)


def _no_step(monkeypatch):
  monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None:
                      None)


def _half_rows(monkeypatch):
  from oatomobile_torch.baselines.learned.dim import train  # pylint: disable=import-outside-toplevel
  nll = train.member_nll

  def half(model, y, context, rng, dropout):
    keep = y.shape[0] // 2
    return nll(model, y[:keep], {k: v[:keep] for k, v in context.items()},
               rng, dropout)

  monkeypatch.setattr(train, "member_nll", half)


def _loss_altered(monkeypatch):
  from oatomobile_torch.baselines.learned.dim import train  # pylint: disable=import-outside-toplevel
  nll = train.member_nll
  monkeypatch.setattr(train, "member_nll",
                      lambda *args: 1.5 * nll(*args))


@pytest.mark.parametrize("fault", [_no_step, _half_rows, _loss_altered])
def test_a_planted_training_fault_is_not_correct(monkeypatch, fault):
  fault(monkeypatch)
  assert failed(_train().checks) > 0


def test_a_sound_training_run_is_correct():
  assert failed(_train().checks) == 0
