"""The diagnostics whose JAX scripts define their rollout inside ``main()``
(``scripts/diag_busytown.py``, ``diag_hills.py``, ``diag_busytown_viz.py``,
``diag_hills_viz.py``) against ``oatomobile_torch.experiments.diag`` on
the CPU: the JAX ``main()`` under a patched ``argv`` and the port's
``main()`` with the same flags (and ``--cpu``) print the same text.

The autopilot crashes on no Hills task within a short horizon, so the
Hills runs replace the policy on both sides with one that drives
straight ahead at full throttle (the JAX package's ``sim.autopilot_policy``,
which the scripts import when ``main`` runs, and the port's
``diag.common.autopilot``): its scenes leave the road or hit an NPC, and
the crash snapshots, their buckets and the drawn crash scenes are held.
"""

import contextlib
import importlib.util
import io
import os

import jax.numpy as jnp
import pytest
import torch

import oatomobile_tpu.sim
from oatomobile_torch.experiments.diag import (busytown, busytown_viz,
                                               common, hills, hills_viz)
from oatomobile_torch.sim.util import constant

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STRAIGHT = (1.0, 0.0, 0.0)  # throttle, steer, brake


def jax_main(name: str, argv) -> str:
  """What ``scripts/diag_<name>.py``'s ``main()`` prints with ``argv``."""
  spec = importlib.util.spec_from_file_location(
      "jax_diag_" + name, os.path.join(ROOT, "scripts",
                                       "diag_" + name + ".py"))
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  out = io.StringIO()
  with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
    mp.setattr("sys.argv", ["diag_" + name + ".py"] + list(argv))
    module.main()
  return out.getvalue()


def port_main(module, argv) -> str:
  out = io.StringIO()
  with contextlib.redirect_stdout(out):
    module.main(list(argv) + ["--cpu"])
  return out.getvalue()


@pytest.fixture
def straight_ahead(monkeypatch):
  """Both packages' autopilot replaced by full throttle, no steering."""
  monkeypatch.setattr(oatomobile_tpu.sim, "autopilot_policy",
                      lambda params, s: (jnp.asarray(STRAIGHT), s))
  monkeypatch.setattr(
      common, "autopilot",
      lambda params, s: (constant(STRAIGHT, s.hero_xy.device).expand(
          s.batch_size, 3), s))


def test_busytown_prints_as_jax():
  argv = ["--episodes", "1", "--horizon", "120"]
  want = jax_main("busytown", argv)
  assert port_main(busytown, argv) == want
  # Eleven tasks; the stopped steps split by cause, red lights among them.
  assert want.count("BusyTown") == 12 and "timeout (11)" in want
  red = [line for line in want.splitlines() if line.startswith("  red")]
  assert red and not red[0].endswith(" 0.0% of stopped steps")


def test_hills_crashes_print_as_jax(straight_ahead):  # pylint: disable=unused-argument,redefined-outer-name
  argv = ["--episodes", "2", "--horizon", "100"]
  want = jax_main("hills", argv)
  assert port_main(hills, argv) == want
  assert "collisions: 0" not in want


def test_busytown_viz_prints_and_draws_as_jax(tmp_path):
  argv = ["--episodes", "1", "--horizon", "40"]
  want = jax_main("busytown_viz", argv + ["--out", str(tmp_path / "jax")])
  got = port_main(busytown_viz, argv + ["--out", str(tmp_path / "torch")])
  assert got.replace(str(tmp_path / "torch"), str(tmp_path / "jax")) == want
  drawn = sorted(os.listdir(tmp_path / "torch"))
  assert drawn == sorted(os.listdir(tmp_path / "jax"))
  assert len(drawn) == want.count("timeout ") == 2


def test_hills_viz_prints_and_draws_as_jax(tmp_path, straight_ahead):  # pylint: disable=unused-argument,redefined-outer-name
  argv = ["--episodes", "2", "--horizon", "100"]
  want = jax_main("hills_viz", argv + ["--out", str(tmp_path / "jax")])
  got = port_main(hills_viz, argv + ["--out", str(tmp_path / "torch")])
  assert got.replace(str(tmp_path / "torch"), str(tmp_path / "jax")) == want
  drawn = sorted(os.listdir(tmp_path / "torch"))
  assert drawn and drawn == sorted(os.listdir(tmp_path / "jax"))


def test_viz_main_raises_without_matplotlib(monkeypatch):
  """The card's machine has no matplotlib: ``main`` says so before the
  rollout, and ``run`` (the data half) needs none."""
  real = importlib.util.find_spec
  monkeypatch.setattr(
      importlib.util, "find_spec",
      lambda name, *a: None if name == "matplotlib" else real(name, *a))
  for module in (busytown_viz, hills_viz):
    with pytest.raises(RuntimeError, match="matplotlib"):
      module.main(["--cpu", "--horizon", "2"])
  r = hills_viz.run(1, 2, device="cpu")
  assert r["m"]["crash"]["npc_xy"].shape[0] == 4
