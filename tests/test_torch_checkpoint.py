"""Checkpoints and loggers of oatomobile_torch: the ``Checkpointer`` round
trips, the reader of the JAX package's ``.flax`` files (without flax or
msgpack) against ``flax.serialization``, ``benchmarks.run``'s checkpoint
loaders, and the CSV / JSONL / terminal loggers' output against the JAX
package's loggers for the same records."""

import argparse
import json
import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oatomobile_torch import rng as rng_lib
from oatomobile_torch.benchmarks import run as trun
from oatomobile_torch.models import BehaviouralModel, ImitativeModel, convert
from oatomobile_torch.parallel import dp as tdp
from oatomobile_torch.utils import checkpoint as tckpt
from oatomobile_torch.utils import flax_msgpack
from oatomobile_torch.utils import loggers as tloggers
from oatomobile_tpu.models.cil import BehaviouralModel as JBehaviouralModel
from oatomobile_tpu.models.dim import ImitativeModel as JImitativeModel
from oatomobile_tpu.utils import loggers as jloggers

torch.set_num_threads(1)

CONTEXT = dict(visual_features=jnp.zeros((1, 100, 100, 2)),
               velocity=jnp.zeros((1, 3)),
               is_at_traffic_light=jnp.zeros((1, 1)),
               traffic_light_state=jnp.zeros((1, 1)))


@pytest.fixture(scope="module")
def jax_trees():
  """JAX init trees of the models ``benchmarks.run`` builds."""
  dim = JImitativeModel(output_shape=(4, 2))
  cil = JBehaviouralModel(output_shape=(40, 2))
  return {
      "dim": [dim.init(jax.random.PRNGKey(k), jnp.zeros((1, 4, 2)),
                       method=dim.log_prob, **CONTEXT) for k in range(2)],
      "cil": cil.init(jax.random.PRNGKey(0), mode=jnp.zeros((1, 1)),
                      **CONTEXT),
  }


def assert_trees_equal(got, want, path=""):
  if isinstance(want, dict):
    assert sorted(got) == sorted(want), path
    for key in want:
      assert_trees_equal(got[key], want[key], path + "/" + key)
  else:
    want = np.asarray(want)
    assert isinstance(got, (np.ndarray, np.generic)), path
    assert got.dtype == want.dtype and got.shape == want.shape, path
    np.testing.assert_array_equal(got, want, err_msg=path)


@pytest.mark.parametrize("which", ["dim", "cil"])
def test_flax_reader_matches_flax(jax_trees, which):
  tree = jax_trees[which]
  tree = tree[0] if which == "dim" else tree
  data = flax.serialization.to_bytes(tree)
  got = flax_msgpack.from_bytes(data)
  assert_trees_equal(got, flax.serialization.msgpack_restore(data))
  assert_trees_equal(got, jax.tree.map(np.asarray, flax.serialization.
                                       to_state_dict(tree)))


def test_flax_reader_types_and_chunks(monkeypatch):
  tree = {"a": np.arange(300, dtype=np.uint8),
          "b": {"c": np.ones((2, 3), np.int32), "s": np.float32(3.5),
                "d": np.arange(6, dtype=np.float64).reshape(3, 2)},
          "n": 7, "neg": -3, "big": 2**40, "f": 1.5, "t": True, "z": None,
          "str": "x" * 40, "l": list(range(20)), "c": 1 + 2j}
  data = flax.serialization.msgpack_serialize(dict(tree))
  got = flax_msgpack.from_bytes(data)
  want = flax.serialization.msgpack_restore(data)
  assert got.keys() == want.keys()
  for key in ("n", "neg", "big", "f", "t", "z", "str", "l", "c"):
    assert got[key] == want[key] and type(got[key]) is type(want[key]), key
  assert_trees_equal({k: got[k] for k in ("a", "b")},
                     {k: want[k] for k in ("a", "b")})
  # Arrays over flax's chunk size are stored as chunked maps.
  monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 64)
  big = {"w": np.arange(100, dtype=np.float32).reshape(4, 25)}
  data = flax.serialization.msgpack_serialize(dict(big))
  assert b"__msgpack_chunked_array__" in data
  np.testing.assert_array_equal(flax_msgpack.from_bytes(data)["w"], big["w"])
  with pytest.raises(ValueError):
    flax_msgpack.from_bytes(data + b"\x00")


def test_checkpointer_round_trips(tmp_path):
  ckpt = tckpt.Checkpointer(str(tmp_path / "ckpts"))
  assert ckpt.latest_epoch() is None and ckpt.restore_latest() is None
  model = ImitativeModel((4, 2), (32, 32), device="cpu")
  for epoch in (3, 11, 7):
    path = ckpt.save(epoch, model.state_dict())
    assert os.path.basename(path) == "model-{}.pt".format(epoch)
  assert ckpt.latest_epoch() == 11
  path = ckpt.save_named("best", model.state_dict())
  assert os.path.basename(path) == "model-best.pt" and ckpt.has_named("best")
  assert not ckpt.has_named("worst")
  assert not any(f.endswith(".tmp") for f in os.listdir(str(tmp_path /
                                                            "ckpts")))
  other = ImitativeModel((4, 2), (32, 32), device="cpu",
                         generator=torch.Generator().manual_seed(1))
  assert ckpt.load(7, other) is other
  for key, value in model.state_dict().items():
    assert torch.equal(other.state_dict()[key], value), key
  for loaded in (ckpt.load_named("best"), ckpt.restore_latest()):
    assert set(loaded) == set(model.state_dict())
  # Another prefix in the same directory is another series.
  ens = tckpt.Checkpointer(str(tmp_path / "ckpts"), prefix="ensemble")
  assert ens.latest_epoch() is None
  ens.save(2, {"x": torch.ones(2)})
  assert ens.latest_epoch() == 2 and ckpt.latest_epoch() == 11


def test_train_state_round_trip(tmp_path):
  """A full train state (weights, Adam's moments, step, key) saved and
  restored gives the same next update."""
  model = BehaviouralModel((8, 2), (32, 32), device="cpu")
  state = tdp.TrainState.create(model, tdp.adam(model, 1e-3),
                                rng_lib.PRNGKey(3))
  batch = dict(lidar=np.full((2, 64, 64, 2), 50, np.uint8),
               velocity=np.ones((2, 3), np.float32),
               is_at_traffic_light=np.zeros((2, 1), np.float32),
               traffic_light_state=np.zeros((2, 1), np.float32),
               player_future=np.cumsum(np.ones((2, 80, 3), np.float32), 1))
  from oatomobile_torch.baselines.learned.cil import train as tcil  # pylint: disable=import-outside-toplevel
  update = tdp.make_update_fn(tcil.make_loss_fn())
  state, _ = update(state, batch)
  ckpt = tckpt.Checkpointer(str(tmp_path), prefix="train_state")
  ckpt.save(0, state.state_dict())
  _, loss_a = update(state, batch)
  again = BehaviouralModel((8, 2), (32, 32), device="cpu",
                           generator=torch.Generator().manual_seed(9))
  restored = tdp.TrainState.create(again, tdp.adam(again, 1e-3),
                                   rng_lib.PRNGKey(0))
  restored.load_state_dict(ckpt.load(0))
  assert restored.step == 1
  _, loss_b = update(restored, batch)
  assert float(loss_a) == float(loss_b)
  for key, value in state.model.state_dict().items():
    assert torch.equal(restored.model.state_dict()[key], value), key


def write_flax(path, tree) -> str:
  with open(path, "wb") as fp:
    fp.write(flax.serialization.to_bytes(tree))
  return path


def assert_model_holds(model, tree):
  want = convert.state_dict(jax.tree.map(np.asarray, tree))
  got = model.state_dict()
  assert set(got) == set(want)
  for key, value in want.items():
    assert torch.equal(got[key], value), key


def test_run_loads_dim_cil_and_rip_checkpoints(jax_trees, tmp_path):
  """``benchmarks.run.make_agent_fn`` builds agents holding the weights of
  ``.flax`` files (and of the port's ``.pt`` files)."""
  dims = [write_flax(str(tmp_path / "model-{}.flax".format(k)), t)
          for k, t in enumerate(jax_trees["dim"])]
  cil = write_flax(str(tmp_path / "cil-0.flax"), jax_trees["cil"])

  def args(**kwargs):
    return argparse.Namespace(device="cpu", cpu=True, noise=0.0,
                              algorithm="WCM", **kwargs)

  agent_fn = trun.make_agent_fn(args(agent="dim", ckpt=dims[0]))
  assert_model_holds(agent_fn.keywords["model"], jax_trees["dim"][0])
  agent_fn = trun.make_agent_fn(args(agent="cil", ckpt=cil))
  assert_model_holds(agent_fn.keywords["model"], jax_trees["cil"])
  agent_fn = trun.make_agent_fn(args(agent="rip", ckpts=dims))
  assert agent_fn.keywords["algorithm"] == "WCM"
  for model, tree in zip(agent_fn.keywords["models"], jax_trees["dim"]):
    assert_model_holds(model, tree)
  # The port's own checkpoint of the same weights.
  pt = tckpt.Checkpointer(str(tmp_path), "port").save(
      0, agent_fn.keywords["models"][1].state_dict())
  agent_fn = trun.make_agent_fn(args(agent="dim", ckpt=pt))
  assert_model_holds(agent_fn.keywords["model"], jax_trees["dim"][1])


RECORDS = [{"epoch": 0, "loss": 1.2345678, "sec": 3.5, "steps": 4},
           {"epoch": 1, "loss": float("nan"), "sec": 2, "steps": 8,
            "val_loss": -0.5, "val_best": True, "tag": np.float32(2.5)},
           {"epoch": 2, "loss": 0.25, "sec": 1.0, "steps": 12}]


def test_csv_logger_matches_jax(tmp_path):
  out = {}
  for name, lib in (("torch", tloggers), ("jax", jloggers)):
    logger = lib.CSVLogger(str(tmp_path / name), label="run")
    for record in RECORDS:
      logger.write(record)
    logger.close()
    with open(logger.file_path) as fp:
      out[name] = fp.read()
    assert os.path.basename(logger.file_path).startswith("run_")
  assert out["torch"] == out["jax"]


def test_jsonl_logger_matches_jax(tmp_path):
  out = {}
  for name, lib in (("torch", tloggers), ("jax", jloggers)):
    logger = lib.JSONLLogger(str(tmp_path / name), label="run")
    for record in RECORDS:
      logger.write(record)
    logger.close()
    assert logger.file_path.endswith("run.jsonl")
    with open(logger.file_path) as fp:
      out[name] = [json.loads(line) for line in fp]
  for got, want in zip(out["torch"], out["jax"]):
    assert "_time" in got
    got.pop("_time")
    want.pop("_time")
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
  assert len(out["torch"]) == len(RECORDS)


def test_terminal_logger_and_gated_factories():
  lines = {"torch": [], "jax": []}
  for name, lib in (("torch", tloggers), ("jax", jloggers)):
    logger = lib.TerminalLogger(label="dim", print_fn=lines[name].append)
    for record in RECORDS:
      logger.write(record)
  assert lines["torch"] == lines["jax"] and len(lines["torch"]) == 3
  tloggers.NoOpLogger().write(RECORDS[0])
  assert callable(tloggers.TensorBoardLogger)
  assert callable(tloggers.WandBLogger)
