"""``oatomobile_torch.entry`` against the repository's ``__graft_entry__``
on the CPU: the DIM entry's loss, its captured step, the one-process dry
run and the command line.  The dry run over four gloo ranks against
``dryrun_multichip(4)`` is ``tests/test_torch_entry_dryrun.py``.

``__graft_entry__`` is imported as ``tests/test_parallel.py`` imports it.
Tolerances: the entry's loss on the JAX entry's own weights (converted by
``models/convert.py``) within rtol 1e-5, as the DIM model tests hold a
log-likelihood; the captured step equal to the eager call exactly (the
same operations on the same inputs).
"""

import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oatomobile_torch import entry, graphs
from oatomobile_torch.models import convert
from oatomobile_torch.parallel import mesh as mesh_lib
from test_torch_compiled import FakeCapturedStep
from test_torch_models import dim_context

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-5


@pytest.fixture(scope="module")
def jax_entry():
  import __graft_entry__ as graft  # pylint: disable=import-outside-toplevel
  fn, args = graft.entry()
  return jax.jit(fn), args


def _inputs(seed: int):
  """Seeded numpy inputs of the entry's shapes (NHWC visual features)."""
  ctx = dim_context(entry.ENTRY_BATCH, seed)
  y = np.random.RandomState(seed).uniform(
      -5, 5, (entry.ENTRY_BATCH,) + entry.OUTPUT_SHAPE).astype(np.float32)
  return (y,) + tuple(ctx[k] for k in entry.CONTEXT)


@pytest.mark.parametrize("inputs", ["zeros", "seeded"])
def test_entry_loss_matches_jax(jax_entry, inputs):
  """The port's ``fn`` on the JAX entry's converted ``params`` gives the
  JAX entry's loss, on its zero example and on seeded inputs."""
  jfn, jargs = jax_entry
  fn, example = entry.entry("cpu")
  params = convert.state_dict(jax.device_get(jargs[0]))
  assert set(params) == set(example[0])
  if inputs == "zeros":
    for got, want in zip(example[1:], jargs[1:]):
      assert tuple(got.shape) == want.shape and not got.any()
    data = tuple(np.asarray(x) for x in jargs[1:])
  else:
    data = _inputs(3)
  want = float(jfn(jargs[0], *map(jnp.asarray, data)))
  got = fn(params, *map(torch.from_numpy, data))
  assert got.shape == () and got.dtype == torch.float32
  np.testing.assert_allclose(float(got), want, rtol=LOSS_RTOL)


def test_captured_entry_equals_eager(monkeypatch):
  """``capture`` under the card's capture and replay played on the CPU:
  two warm-up calls, the capture, then replays, each on new inputs and
  each equal to the eager ``fn`` exactly."""
  monkeypatch.setattr(graphs, "CapturedStep", FakeCapturedStep)
  FakeCapturedStep.instances = []
  fn, example = entry.entry("cpu")
  run = entry.capture(fn, example)
  assert len(FakeCapturedStep.instances) == 1
  step = FakeCapturedStep.instances[0]
  for call in range(5):
    params = {k: v + 0.01 * call for k, v in example[0].items()}
    args = (params,) + tuple(map(torch.from_numpy, _inputs(call)))
    got = run(*args)
    assert torch.equal(got, fn(*args)), call
    assert step.captured == (call >= graphs.WARMUP_STEPS)
  with pytest.raises(ValueError):
    run({}, *args[1:])


def test_entry_defaults_to_the_card():
  if torch.cuda.is_available():
    pytest.skip("a CUDA device is present: the default is usable here")
  for call in (entry.entry, lambda: entry.dryrun(mesh=None)):
    with pytest.raises(RuntimeError, match="device='cpu'"):
      call()


def test_dryrun_one_process(capsys):
  """The 1x1 mesh: the JAX function's numbers at one device and its four
  lines, a finite loss."""
  got = entry.dryrun(device="cpu")
  assert got["mesh"] == (1, 1) and got["scenes"] == 2
  assert got["ensemble"] == 2
  # 115 steps hold window centres 20, 25, 30 of every scene.
  assert got["windows"] == got["batch"] == 3 * 2
  assert got["lidar_shape"] == (3, 2, 100, 100, 2)
  assert got["lidar_dtype"] == "uint8"
  assert np.isfinite(got["loss"]) and got["loss"] > 0
  lines = capsys.readouterr().out.splitlines()
  assert [line.split(":")[0] for line in lines] == [
      "rollout", "collect", "train", "dryrun_multichip OK"]
  assert lines[0] == "rollout: scenes=2 sharding={}".format(
      entry._placements(mesh_lib.batch_sharding(None)))  # pylint: disable=protected-access
  assert lines[1] == "collect: windows=6 lidar=(3, 2, 100, 100, 2) uint8"
  assert lines[3] == ("dryrun_multichip OK: mesh=(1x1), rollout->collect->"
                      "train, ensemble=2, batch=6, loss={:.3f}".format(
                          got["loss"]))


def test_command_line_runs_entry_then_dryrun():
  proc = subprocess.run(
      [sys.executable, "-m", "oatomobile_torch.entry", "--cpu"], cwd=ROOT,
      env=dict(os.environ, OMP_NUM_THREADS="1"), capture_output=True,
      text=True, timeout=300, check=False)
  assert proc.returncode == 0, proc.stderr[-4000:]
  lines = proc.stdout.splitlines()
  assert re.fullmatch(r"entry loss: \d+\.\d+", lines[0]), lines
  assert lines[-1].startswith("dryrun_multichip OK: mesh=(1x1), ")
  assert len(lines) == 5
