"""The port's device mesh (``oatomobile_torch.parallel.mesh``) against the
JAX package's on the CPU.

Without a process group: the helpers' semantics on the 1x1 mesh and on
mesh descriptions of a larger world, the sharded draws, and
``ensemble_mesh``'s ``(n_data, n_model)`` against the JAX function's.

With two gloo ranks (``tests/torch_mesh_worker.py``, started once for
the module: every scenario runs in one pair of processes, whose start and
collectives time out after 60 s): the ports of ``tests/test_parallel.py``
and ``tests/test_pipeline.py``'s mesh tests.  Tolerances: the toy update
within rtol 1e-5 (loss) and atol 1e-5 (weights) of the JAX update on the
8-device mesh, as the JAX test holds its own; ``BatchedEnv(mesh=...)``
within atol 1e-5 of the JAX ``BatchedEnv(mesh=...)`` (``hero_xy``,
``distance``) and equal to the port's single process exactly (scenes do
not depend on their neighbours); the DIM update on converted weights
against the JAX sharded update within the tolerances of
``tests/torch_train_helpers.py``; the trainers with ``use_mesh=True``
within rtol 2e-4 / atol 2e-5 of ``use_mesh=False`` (the JAX RIP test's):
RIP's members over mp at every element; DIM and CIL over dp, whose
gradient is a mean of two shards' in another order, at every element but
at most 5e-4 of them (Adam's steps take the sign of gradients that are
float32 noise, as in ``tests/torch_train_helpers.py``), each of those
within two Adam steps (2 lr per step).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from oatomobile_torch import rng as rng_lib
from oatomobile_torch.baselines.learned.cil import train as tcil
from oatomobile_torch.baselines.learned.dim import train as tdim
from oatomobile_torch.baselines.learned.rip import train as trip
from oatomobile_torch.datasets.carla import CARLADataset
from oatomobile_torch.envs.batched import BatchedEnv
from oatomobile_torch.models import convert
from oatomobile_torch.parallel import mesh as tmesh
from oatomobile_tpu.parallel import dp as jdp
from oatomobile_tpu.parallel import mesh as jmesh
import torch_mesh_worker as worker
from torch_train_helpers import (INPUT, LOSS_RTOL, LR, UNRESOLVED_FRACTION,
                                 check_update, dim_init, jax_dim_loss, key_of,
                                 make_batch, numpy_tree)

torch.set_num_threads(1)

WORLD = 2
# The whole two-rank run: two process starts, the scenarios and the
# trainers at their small sizes (each collective has its own 60 s).
JOIN_SECONDS = 300
TRAIN_RTOL, TRAIN_ATOL = 2e-4, 2e-5


def cpu_mesh(n_data: int, n_model: int, rank: int) -> tmesh.Mesh:
  """A mesh description of a larger world, for the helpers that need no
  collective."""
  return tmesh.Mesh({"dp": n_data, "mp": n_model}, rank,
                    torch.device("cpu"))


# -- without a process group ---------------------------------------------------


def test_make_mesh_without_a_group_is_one_by_one():
  mesh = tmesh.make_mesh(device="cpu")
  assert mesh.shape == {"dp": 1, "mp": 1} and mesh.size == 1
  assert mesh.device_mesh is None and mesh.device == torch.device("cpu")
  assert mesh.group("dp") is None
  tree = {"a": torch.arange(6.0), "b": [np.ones(4)], "s": torch.tensor(2)}
  for fn in (tmesh.shard_batch, tmesh.replicate, tmesh.gather_batch,
             tmesh.gather_ensemble):
    out = fn(mesh, tree)
    assert out["a"] is tree["a"] and out["b"][0] is tree["b"][0]
  out = tmesh.shard_ensemble(mesh, tree, 6)
  assert torch.equal(out["a"], tree["a"])
  assert tmesh.ensemble_mesh(4, device="cpu").shape == {"dp": 1, "mp": 1}
  assert tmesh.is_main() and tmesh.world_size() == 1


def test_make_mesh_refuses_what_it_cannot_build(monkeypatch):
  with pytest.raises(ValueError):
    tmesh.make_mesh(n_data=2, device="cpu")
  if not torch.cuda.is_available():
    with pytest.raises(RuntimeError):
      tmesh.make_mesh()
  # A world of two whose group cannot start raises; it never carries on
  # as a world of one.
  monkeypatch.setenv("WORLD_SIZE", "2")
  monkeypatch.delenv("MASTER_ADDR", raising=False)
  with pytest.raises((ValueError, RuntimeError)):
    tmesh.make_mesh(device="cpu")
  assert not torch.distributed.is_initialized()


def test_placements():
  from torch.distributed.tensor import Replicate, Shard  # pylint: disable=import-outside-toplevel
  mesh = tmesh.make_mesh(device="cpu")
  assert tmesh.batch_sharding(mesh) == (Shard(0), Replicate())
  assert tmesh.replicated(mesh) == (Replicate(), Replicate())


@pytest.mark.parametrize("rank", range(4))
def test_shard_batch_keeps_this_ranks_rows(rank):
  """On a (2, 2) mesh rank r keeps dp block r // 2 of every leaf; scalars
  and the SceneState's nested fields follow; a batch that does not
  divide raises."""
  mesh = cpu_mesh(2, 2, rank)
  tree = {"x": torch.arange(8).reshape(4, 2), "n": np.arange(4.0),
          "s": torch.tensor(1.0)}
  out = tmesh.shard_batch(mesh, tree)
  lo = 2 * (rank // 2)
  assert torch.equal(out["x"], tree["x"][lo:lo + 2])
  np.testing.assert_array_equal(out["n"], tree["n"][lo:lo + 2])
  assert out["s"] is tree["s"]
  state = BatchedEnv("Town02", 4, num_vehicles=2, device="cpu").state
  shard = tmesh.shard_batch(mesh, state)
  assert torch.equal(shard.hero_xy, state.hero_xy[lo:lo + 2])
  assert torch.equal(shard.pid_lat.err_buf, state.pid_lat.err_buf[lo:lo + 2])
  with pytest.raises(ValueError):
    tmesh.shard_batch(mesh, {"x": torch.zeros(3)})


@pytest.mark.parametrize("rank", range(4))
def test_shard_ensemble_keeps_this_ranks_members(rank):
  mesh = cpu_mesh(2, 2, rank)
  stacked = {"w": torch.arange(12.0).reshape(4, 3), "step": torch.tensor(3)}
  out = tmesh.shard_ensemble(mesh, stacked, 4)
  lo = 2 * (rank % 2)
  assert torch.equal(out["w"], stacked["w"][lo:lo + 2])
  assert torch.equal(out["step"], stacked["step"])


@pytest.mark.parametrize("draw", ["uniform", "normal"])
def test_draw_rows_draws_the_global_batchs_rows(draw):
  fn = getattr(rng_lib, draw)
  key = rng_lib.PRNGKey(7)
  full = fn(key, (8, 3))
  assert torch.equal(tmesh.draw_rows(fn, key, (8, 3)), full)
  with tmesh.global_rows(4, 6, 8):
    assert torch.equal(tmesh.draw_rows(fn, key, (2, 3)), full[4:6])
    with pytest.raises(ValueError):
      tmesh.draw_rows(fn, key, (3, 3))


@pytest.mark.parametrize("num_models", [1, 2, 3, 4, 5, 6, 8])
def test_ensemble_shape_matches_jax(num_models, devices):
  for n in range(1, len(devices) + 1):
    want = jmesh.ensemble_mesh(num_models, devices=devices[:n]).shape
    assert tmesh.ensemble_shape(num_models, n) == (want["dp"], want["mp"]), n


# -- two gloo ranks ------------------------------------------------------------


@pytest.fixture(scope="module")
def pack(tmp_path_factory):
  """Town02, 2 episodes of 200 steps (the trainer tests' pack), its LIDAR
  then made dense: the collected LIDAR is 3% nonzero, which leaves
  GroupNorm groups of nearly constant values whose gradients float32 does
  not resolve (``tests/torch_train_helpers.py``), and an Adam step takes
  the sign of such a gradient, which the order of a sum decides."""
  out = str(tmp_path_factory.mktemp("pack"))
  CARLADataset.collect_packed("Town02", out, num_episodes=2, num_steps=200,
                              seed=21, device="cpu")
  path = os.path.join(out, "lidar.npy")
  lidar = np.load(path)
  np.save(path, np.random.RandomState(0).randint(
      0, 256, lidar.shape).astype(lidar.dtype))
  return out


@pytest.fixture(scope="module")
def inputs(pack):
  rs = np.random.RandomState(0)
  _, tree = dim_init(0)
  return {"pack": pack, "input_size": INPUT,
          "toy_batch": {"x": rs.randn(16, 8).astype(np.float32),
                        "y": rs.randn(16, 4).astype(np.float32)},
          "dim_tree": tree, "dim_weights": convert.state_dict(tree),
          "dim_batch": make_batch(8, 1), "dim_key": key_of(42)}


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
  """Every scenario on two gloo ranks; returns each rank's results and
  the directory the ranks wrote to."""
  out = str(tmp_path_factory.mktemp("ranks"))
  worker.join(worker.start(
      WORLD, {k: v for k, v in inputs.items() if k != "dim_tree"}, out),
              JOIN_SECONDS)
  return worker.results(out, WORLD), out


def test_two_ranks_form_the_meshes(ranks):
  results, _ = ranks
  for rank, res in enumerate(results):
    assert res["mesh"] == ({"dp": 2, "mp": 1}, rank, rank)
    # K = 4 over 2 ranks: the members over mp, as the JAX divisor rule.
    assert res["rip_mesh"] == ({"dp": 1, "mp": 2}, rank)


def _leaves(tree):
  if isinstance(tree, dict):
    return [x for k in sorted(tree) for x in _leaves(tree[k])]
  if isinstance(tree, (list, tuple)):
    return [x for v in tree for x in _leaves(v)]
  return [tree]


@pytest.mark.parametrize("key", ["toy", "toy_accum", "env", "dim_update",
                                 "dim_train", "cil_train", "rip_train"])
def test_ranks_hold_the_same_global_values(ranks, key):
  a, b = (res[key] for res in ranks[0])
  for x, y in zip(_leaves(a), _leaves(b)):
    if isinstance(x, torch.Tensor):
      assert torch.equal(x, y)
    else:
      assert x == y


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_toy_update_matches_jax_mesh_and_one_process(ranks, inputs,
                                                     grad_accum):
  """tests/test_parallel.py::test_dp_sharded_matches_single_device: five
  Adam steps of the toy on two ranks against the JAX update on the
  8-device mesh and the port's single process (and, accumulating two
  micro-batches a step, against the single process)."""
  losses, w, b = ranks[0][0]["toy" if grad_accum == 1 else "toy_accum"]
  one = worker.toy_run(None, inputs["toy_batch"], grad_accum=grad_accum)
  np.testing.assert_allclose(losses, one[0], rtol=1e-5)
  np.testing.assert_allclose(w.numpy(), one[1].numpy(), atol=1e-5)
  np.testing.assert_allclose(b.numpy(), one[2].numpy(), atol=1e-5)
  if grad_accum > 1:
    return

  def loss_fn(params, batch, rng):
    del rng
    pred = batch["x"] @ params["w"] + params["b"]
    return jnp.mean((pred - batch["y"])**2)

  tx = optax.adam(1e-2)
  mesh = jmesh.make_mesh()
  assert mesh.devices.size == 8
  update = jdp.make_update_fn(loss_fn, tx, mesh=mesh)
  state = jdp.TrainState.create({"w": jnp.ones((8, 4)) * 0.1,
                                 "b": jnp.zeros((4,))}, tx,
                                jax.random.PRNGKey(0))
  state = jdp.replicate_state(mesh, state)
  batch = {k: jnp.asarray(v) for k, v in inputs["toy_batch"].items()}
  for _ in range(worker.TOY_STEPS):
    state, loss = update(state, batch)
  np.testing.assert_allclose(losses[-1], float(loss), rtol=1e-5)
  np.testing.assert_allclose(w.numpy(), np.asarray(state.params["w"]),
                             atol=1e-5)


def test_batched_env_mesh_matches_jax_and_one_process(ranks):
  """tests/test_parallel.py::test_batched_env_mesh_matches_unsharded: the
  scenes over two ranks, gathered, against the JAX BatchedEnv on the
  8-device mesh and the port's single process (reset, one step and a
  10-step rollout collecting the velocity)."""
  from oatomobile_tpu.envs.batched import BatchedEnv as JBatchedEnv  # pylint: disable=import-outside-toplevel
  got = ranks[0][0]["env"]
  want = worker.env_run(None)
  assert set(got) == set(want)
  for key, value in want.items():
    assert torch.equal(got[key], value), key
  assert got["collected_velocity"].shape == (worker.ENV_STEPS, 8, 3)

  jenv = JBatchedEnv("Town02", mesh=jmesh.make_mesh(), **worker.ENV)
  jfinal, _, jstats = jenv.rollout(worker.ENV_STEPS)
  np.testing.assert_allclose(got["hero_xy"].numpy(),
                             np.asarray(jfinal.hero_xy), atol=1e-5)
  np.testing.assert_allclose(got["stats_distance"].numpy(),
                             np.asarray(jstats["distance"]), atol=1e-5)
  assert float(got["stats_distance"].sum()) > 0.0


def test_dim_update_matches_jax_sharded_update(ranks, inputs):
  """One DIM update of the converted weights on two ranks against the JAX
  update on the 8-device mesh (the batch sharded over dp)."""
  from oatomobile_tpu.models.dim import ImitativeModel as JImitativeModel  # pylint: disable=import-outside-toplevel
  got = ranks[0][0]["dim_update"]
  model = JImitativeModel((4, 2), INPUT)
  loss_fn = jax_dim_loss(model)
  mesh = jmesh.make_mesh()
  tx = optax.adam(LR)
  params = jax.tree.map(jnp.asarray, inputs["dim_tree"])
  batch = jmesh.shard_batch(mesh, {k: jnp.asarray(v) for k, v in
                                   inputs["dim_batch"].items()})
  key = jnp.asarray(inputs["dim_key"])
  _, step_key = jax.random.split(key)
  j_loss, j_grads = jax.jit(jax.value_and_grad(loss_fn))(params, batch,
                                                         step_key)
  state = jdp.replicate_state(mesh, jdp.TrainState.create(params, tx, key))
  state, loss = jdp.make_update_fn(loss_fn, tx, mesh=mesh)(state, batch)
  np.testing.assert_allclose(got["loss"], float(loss), rtol=LOSS_RTOL)
  np.testing.assert_allclose(float(j_loss), float(loss), rtol=1e-6)
  check_update(got["state_dict"], got["grads"],
               convert.state_dict(numpy_tree(state.params)),
               convert.state_dict(numpy_tree(j_grads)),
               inputs["dim_weights"])


def _unsharded(which, pack, out):
  kwargs = dict(worker.TRAIN, use_mesh=False)
  if which == "dim_train":
    return tdim.train(pack, out, plot_every=0, input_size=INPUT,
                      **kwargs).model.state_dict()
  if which == "cil_train":
    return tcil.train(pack, out, **kwargs).model.state_dict()
  return trip.stack_params(trip.train(pack, out, num_models=4,
                                      save_model_frequency=1, **kwargs))


@pytest.mark.parametrize("which", ["dim_train", "cil_train", "rip_train"])
def test_trainer_use_mesh_matches_unsharded(ranks, pack, tmp_path, which):
  """tests/test_pipeline.py::test_rip_mp_sharded_matches_unsharded and its
  DIM and CIL counterparts: two updates over two ranks (DIM and CIL over
  dp = 2; RIP's K = 4 members over mp = 2) against ``use_mesh=False``;
  rank 0 alone wrote the logs and checkpoints."""
  results, out = ranks
  got = results[0][which]
  want = _unsharded(which, pack, str(tmp_path / "one"))
  assert set(got) == set(want)
  off = total = 0
  for name, value in want.items():
    g, w = got[name].numpy(), value.numpy()
    if which == "rip_train":
      np.testing.assert_allclose(g, w, rtol=TRAIN_RTOL, atol=TRAIN_ATOL,
                                 err_msg=name)
      continue
    bad = ~np.isclose(g, w, rtol=TRAIN_RTOL, atol=TRAIN_ATOL)
    # An Adam step moves an element by at most ~lr: one whose gradient
    # is float32 noise may go the other way in either run.
    assert (np.abs(g - w)[bad] <= 2 * LR * worker.TRAIN[
        "max_steps_per_epoch"]).all(), name
    off += int(bad.sum())
    total += bad.size
  assert off <= UNRESOLVED_FRACTION * total, (off, total)
  label = which.split("_")[0]
  with open(os.path.join(out, label, "logs",
                         "{}_train.jsonl".format(label))) as fp:
    assert len(fp.readlines()) == 1  # one epoch, one writer
  ckpts = sorted(os.listdir(os.path.join(out, label, "ckpts")))
  assert ckpts == sorted(os.listdir(str(tmp_path / "one" / "ckpts")))
