"""The port's DIM, CIL and RIP ``train()`` end to end on a tiny pack on the
CPU: losses finite and falling, checkpoints written, the device-resident
loader giving the streaming loader's losses, and resumes (the JAX package's
own pipeline tests, ``tests/test_pipeline.py`` and
``tests/test_datasets_extra.py``, at their sizes)."""

import json
import os

import numpy as np
import pytest
import torch

from oatomobile_torch.baselines.learned.cil import train as tcil
from oatomobile_torch.baselines.learned.dim import train as tdim
from oatomobile_torch.baselines.learned.rip import train as trip
from oatomobile_torch.datasets.carla import CARLADataset
from oatomobile_torch.utils.checkpoint import Checkpointer

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pack(tmp_path_factory):
  """Town02, 2 episodes of 200 steps, a window every 5 steps."""
  out = str(tmp_path_factory.mktemp("pack"))
  n = CARLADataset.collect_packed("Town02", out, num_episodes=2,
                                  num_steps=200, seed=21, device="cpu")
  assert n >= 20
  return out


def records(out: str, name: str) -> list:
  with open(os.path.join(out, "logs", name + ".jsonl")) as fp:
    return [json.loads(line) for line in fp]


def test_dim_train_loss_falls_and_checkpoints(pack, tmp_path):
  out = str(tmp_path / "dim")
  state = tdim.train(pack, out, batch_size=4, num_epochs=3,
                     save_model_frequency=2, max_steps_per_epoch=2,
                     val_fraction=0.25, device="cpu")
  recs = records(out, "dim_train")
  losses = [r["loss"] for r in recs]
  assert np.isfinite(losses).all() and losses[-1] < losses[0]
  assert all("val_loss" in r for r in recs) and state.step == 6
  ckpts = sorted(os.listdir(os.path.join(out, "ckpts")))
  assert ckpts == ["model-1.pt", "model-2.pt", "model-best.pt"]
  assert os.path.exists(os.path.join(out, "state", "train_state-2.pt"))
  # plot_every=1 draws a sampled plan over the BEV input every epoch.
  plot = str(tmp_path / "plot")
  tdim.train(pack, plot, batch_size=4, num_epochs=1, max_steps_per_epoch=1,
             plot_every=1, device="cpu")
  assert os.path.getsize(os.path.join(plot, "plots", "epoch_0.png")) > 0


def test_dim_resident_loader_matches_streaming(pack, tmp_path):
  """One epoch from the device-resident pack and one streamed from the
  host draw the same batches, so they give the same losses (restart
  oversampling, which only the resident loader does, off)."""
  recs = {}
  for name, flag in (("dev", True), ("host", False)):
    out = str(tmp_path / name)
    tdim.train(pack, out, batch_size=2, num_epochs=1, device_data=flag,
               oversample_restarts=0, device="cpu")
    recs[name] = records(out, "dim_train")[0]
  assert recs["dev"]["steps"] == recs["host"]["steps"] > 0
  assert abs(recs["dev"]["loss"] - recs["host"]["loss"]) < 1e-4
  assert abs(recs["dev"]["val_loss"] - recs["host"]["val_loss"]) < 1e-4


def test_dim_resume_is_exact(pack, tmp_path):
  """Stopped after epoch 0 and resumed, the run's epoch-1 loss and final
  weights equal those of an uninterrupted run."""
  kwargs = dict(batch_size=4, save_model_frequency=1, max_steps_per_epoch=3,
                device="cpu")
  full = tdim.train(pack, str(tmp_path / "full"), num_epochs=2, **kwargs)
  tdim.train(pack, str(tmp_path / "cut"), num_epochs=1, **kwargs)
  resumed = tdim.train(pack, str(tmp_path / "cut"), num_epochs=2,
                       resume=True, **kwargs)
  want = records(str(tmp_path / "full"), "dim_train")
  got = records(str(tmp_path / "cut"), "dim_train")
  assert [r["epoch"] for r in got] == [0, 1]
  assert got[1]["loss"] == want[1]["loss"]
  assert got[1]["steps"] == want[1]["steps"] == resumed.step
  for key, value in full.model.state_dict().items():
    assert torch.equal(resumed.model.state_dict()[key], value), key


def test_cil_train_and_resume(pack, tmp_path):
  out = str(tmp_path / "cil")
  state = tcil.train(pack, out, batch_size=4, num_epochs=1,
                     max_steps_per_epoch=2, device="cpu")
  assert state.step == 2
  first = records(out, "cil_train")
  assert np.isfinite(first[0]["loss"]) and "val_loss" in first[0]
  assert os.path.exists(os.path.join(out, "ckpts", "model-0.pt"))
  assert os.path.exists(os.path.join(out, "ckpts", "model-best.pt"))
  # A second run resumes after the newest checkpoint, the best val loss
  # read back from the log.
  best = os.path.getmtime(os.path.join(out, "ckpts", "model-best.pt"))
  tcil.train(pack, out, batch_size=4, num_epochs=2, max_steps_per_epoch=2,
             device="cpu")
  recs = records(out, "cil_train")
  assert [r["epoch"] for r in recs] == [0, 1]
  improved = recs[1]["val_loss"] < recs[0]["val_loss"]
  assert recs[1].get("val_best", False) == improved
  assert (os.path.getmtime(os.path.join(out, "ckpts", "model-best.pt")) >
          best) == improved


def test_rip_train_and_resume(pack, tmp_path):
  out = str(tmp_path / "rip")
  members = trip.train(pack, out, num_models=2, batch_size=4, num_epochs=1,
                       max_steps_per_epoch=2, grad_accum=2, device="cpu")
  recs = records(out, "rip_train")
  assert np.isfinite(recs[0]["loss"]) and recs[0]["models"] == 2
  ckpt = Checkpointer(os.path.join(out, "ckpts"), prefix="ensemble")
  assert ckpt.latest_epoch() == 0 and ckpt.has_named("best")
  stacked = ckpt.load(0)
  for k, member in enumerate(members):
    for name, value in trip.unstack_params(stacked, k).items():
      assert torch.equal(member.state_dict()[name], value), name
  resumed = trip.train(pack, out, num_models=2, batch_size=4, num_epochs=2,
                       max_steps_per_epoch=2, grad_accum=2, device="cpu")
  assert [r["epoch"] for r in records(out, "rip_train")] == [0, 1]
  assert ckpt.latest_epoch() == 1 and len(resumed) == 2
  with pytest.raises(ValueError):
    trip.train(pack, out, batch_size=5, grad_accum=2, device="cpu")
