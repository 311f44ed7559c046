"""The port's flow profile, dashboard demo and scaled DIM run on the CPU:
``profile_flow``'s JSON line carries the JAX script's keys
(``scripts/profile_flow.py``, run here at two scenes) and its own
(the captured plan's replay and the eager one); ``demo_dashboard`` writes
its GIF (imageio is here; the card's machine has none); ``train_dim_full``
collects, trains and evaluates once, and a second run collects and
trains nothing.
"""

import contextlib
import importlib.util
import io
import json
import os

import pytest
import torch

from oatomobile_torch.experiments import (demo_dashboard, pipeline,
                                          profile_flow, train_dim_full)
from test_torch_experiments import _tasks, jax_script

torch.set_num_threads(1)


def test_profile_flow_line_has_the_jax_keys(monkeypatch):
  out = io.StringIO()
  with contextlib.redirect_stdout(out):
    monkeypatch.setattr("sys.argv", ["profile_flow.py", "-B", "2",
                                     "--iters", "1"])
    jax_script("profile_flow", {}).main()
  want = json.loads(out.getvalue().strip().splitlines()[-1])
  out = io.StringIO()
  with contextlib.redirect_stdout(out):
    profile_flow.main(["--cpu", "-B", "2", "--iters", "1"])
  got = json.loads(out.getvalue())
  assert set(want) <= set(got)
  assert got["B"] == want["B"] == 2 and got["backend"] == want["backend"]
  assert set(got) - set(want) == {"plan20_replay_ms", "plan_share_pct_eager"}
  assert all(got[k] > 0 for k in got if k.endswith("_ms"))
  with pytest.raises(ValueError, match="card"):
    profile_flow.run(2, 1, "cpu", profile=True)


def test_dashboard_writes_a_gif(tmp_path, monkeypatch):
  out = str(tmp_path / "dashboard.gif")
  assert demo_dashboard.run("Roundabouts0-v0", steps=6, out=out, every=3,
                            device="cpu") == out
  with open(out, "rb") as fp:
    assert fp.read(6) in (b"GIF87a", b"GIF89a")
  # Without imageio (the card's machine) it raises before the episode.
  real = importlib.util.find_spec
  monkeypatch.setattr(
      importlib.util, "find_spec",
      lambda name, *a: None if name == "imageio" else real(name, *a))
  with pytest.raises(RuntimeError, match="imageio"):
    demo_dashboard.run(out=str(tmp_path / "none.gif"), device="cpu")
  assert not os.path.exists(tmp_path / "none.gif")


def test_train_dim_full_resumes(tmp_path, capsys):
  kwargs = dict(out=str(tmp_path), episodes=2, ep_steps=120, noise=0.1,
                epochs=1, batch=4, horizon=2, device="cpu",
                tasks=_tasks(pipeline.suites()["carnovel"],
                             ("Hills0-v0",)))
  first = train_dim_full.run(**kwargs)
  logged = capsys.readouterr().out
  assert "collect chunk 0" in logged and "pack" in logged
  assert first["num_samples"] > 0 and len(first["train_losses"]) == 1
  assert first["carnovel_dim"]["episodes"] == 1
  with open(os.path.join(str(tmp_path), "summary.json")) as fp:
    assert json.load(fp) == first
  second = train_dim_full.run(**kwargs)
  logged = capsys.readouterr().out
  assert "collect chunk" not in logged and "epoch = " not in logged
  # As the JAX script: no sample count without a collection.
  assert "num_samples" not in second
  assert second["train_losses"] == first["train_losses"]
  assert second["carnovel_dim"] == first["carnovel_dim"]
