"""``oatomobile_torch.entry.dryrun`` over four gloo ranks (a 2x2 mesh, the
smallest where both axes are above 1) against the repository's
``__graft_entry__.dryrun_multichip(4)`` on four of the JAX package's
virtual CPU devices.

The JAX dry run runs in its own process (``tests/conftest.py``'s
8-device platform, ``__graft_entry__`` imported as
``tests/test_parallel.py`` imports it) while the port's ranks run, each
spawned by ``tests/torch_mesh_worker.py`` under one join timeout (a hung
rank fails).  The ranks start from the JAX members' initial weights,
``model.init(PRNGKey(k))`` for k < 4, converted by ``models/convert.py``.

Held: the printed scenes, mesh, windows, the packed LIDAR's global shape
and dtype, ensemble and batch equal the JAX lines'; the loss is finite
and the same on every rank.  The loss is held within rtol 1e-5 (the
entry's tolerance: the same inputs through the two models) against the
JAX dry run's loss function, the members' mean of ``-mean(log_prob)``,
evaluated unsharded by the JAX package on the dry run's packed windows.
It is not held against the JAX line's printed loss: with the stacked
members sharded over ``mp``, XLA's CPU program for the vmapped members
gives other per-member NLLs than the same function unsharded (at this
size 259.173 printed against 256.940, 8.7e-3 apart, while the data of
the sharded and the unsharded JAX rollouts are equal), so the printed
value departs from the function it computes by more than any rounding.
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

from oatomobile_torch import entry
from oatomobile_torch.datasets.carla import _device_pack_windows
from oatomobile_torch.envs.batched import BatchedEnv
from oatomobile_torch.models import convert
from oatomobile_tpu.models.dim import ImitativeModel as JImitativeModel
import torch_mesh_worker as worker

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
# The JAX dry run's compiles take ~80 s on one CPU; the ranks run beside it.
JOIN_SECONDS = 300
LOSS_RTOL = 1e-5
JAX_DRYRUN = """
import os
os.environ["JAX_NUM_CPU_DEVICES"] = "8"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
import __graft_entry__ as graft
graft.dryrun_multichip({})
""".format(WORLD)


def jax_members(ensemble: int) -> list:
  """The JAX dry run's members' initial weights, ``model.init(
  PRNGKey(k))`` (flax's initial values depend on the key and the shapes
  only, not on the batch)."""
  model = JImitativeModel(output_shape=(4, 2))
  ctx = dict(visual_features=jnp.zeros((1, 100, 100, 2)),
             velocity=jnp.zeros((1, 3)),
             is_at_traffic_light=jnp.zeros((1, 1)),
             traffic_light_state=jnp.zeros((1, 1)))
  init = jax.jit(lambda key: model.init(key, jnp.zeros((1, 4, 2)),
                                        method=model.log_prob, **ctx))
  return [jax.device_get(init(jax.random.PRNGKey(k)))
          for k in range(ensemble)]


def jax_unsharded_loss(members: list, scenes: int) -> float:
  """The JAX dry run's loss function (the members' mean NLL) by the JAX
  model, unsharded, on the dry run's packed windows of ``scenes`` scenes
  (the port's rollout and packing, which every rank computes)."""
  env = BatchedEnv(entry.TOWN, scenes, num_vehicles=entry.VEHICLES, seed=0,
                   auto_reset=False, device="cpu")
  _, collected, _ = env.rollout(entry.ROLLOUT_STEPS, collect=entry.COLLECT)
  packed = _device_pack_windows(collected, entry.MODALITIES, entry.PAST,
                                entry.FUTURE, entry.FRAME_SKIP,
                                entry.IMAGE_SIZE)

  def flat(x):
    x = np.swapaxes(x.numpy(), 0, 1)
    return x.reshape((-1,) + x.shape[2:])

  y = flat(packed["player_future"])[..., :2][:, ::20][:, :4]
  ctx = {"visual_features": flat(packed["lidar"]).astype(np.float32) / 255}
  for key in entry.CONTEXT[1:]:
    ctx[key] = flat(packed[key]).astype(np.float32)
  model = JImitativeModel(output_shape=(4, 2))
  nll = jax.jit(lambda params: -jnp.mean(model.apply(
      params, jnp.asarray(y), method=model.log_prob,
      **{k: jnp.asarray(v) for k, v in ctx.items()})))
  return float(np.mean([float(nll(params)) for params in members]))


def parse(lines: str) -> dict:
  """The numbers of the JAX dry run's printed lines."""
  scenes = re.search(r"rollout: scenes=(\d+)", lines)
  collect = re.search(r"collect: windows=(\d+) lidar=\(([\d, ]+)\) (\w+)",
                      lines)
  done = re.search(r"dryrun_multichip OK: mesh=\((\d+)x(\d+)\), "
                   r"rollout->collect->train, ensemble=(\d+), batch=(\d+), "
                   r"loss=([\d.]+)", lines)
  assert scenes and collect and done, lines[-4000:]
  return {"scenes": int(scenes.group(1)),
          "windows": int(collect.group(1)),
          "lidar_shape": tuple(int(x) for x in collect.group(2).split(",")),
          "lidar_dtype": collect.group(3),
          "mesh": (int(done.group(1)), int(done.group(2))),
          "ensemble": int(done.group(3)), "batch": int(done.group(4)),
          "loss": float(done.group(5))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
  """(the JAX dry run's numbers, each rank's return, each rank's
  output)."""
  jax_proc = subprocess.Popen(
      [sys.executable, "-c", JAX_DRYRUN], cwd=ROOT,
      env=dict(os.environ, PYTHONPATH=ROOT), stdout=subprocess.PIPE,
      stderr=subprocess.DEVNULL)
  try:
    out = str(tmp_path_factory.mktemp("dryrun"))
    # 2 x mp members (the JAX rule: mp = 2 on an even world).
    members = jax_members(4)
    procs = worker.start(
        WORLD, {"init_states": [convert.state_dict(m) for m in members]},
        out, "dryrun")
    # 2 scenes a dp rank, dp = 2.
    unsharded = jax_unsharded_loss(members, 4)
    logs = worker.join(procs, JOIN_SECONDS)
    jax_out = jax_proc.communicate(timeout=JOIN_SECONDS)[0].decode()
  finally:
    jax_proc.kill()
  assert jax_proc.returncode == 0, jax_out[-4000:]
  return (dict(parse(jax_out), unsharded_loss=unsharded),
          worker.results(out, WORLD), logs)


def test_dryrun_reports_the_jax_numbers(runs):
  want, ranks, _ = runs
  assert want["mesh"] == (2, 2)
  for got in ranks:
    for key in ("scenes", "mesh", "windows", "lidar_shape", "lidar_dtype",
                "ensemble", "batch"):
      assert got[key] == want[key], key


def test_dryrun_loss_is_global_and_matches_the_jax_function(runs):
  want, ranks, _ = runs
  losses = [got["loss"] for got in ranks]
  assert all(np.isfinite(losses)) and len(set(losses)) == 1, losses
  np.testing.assert_allclose(losses[0], want["unsharded_loss"],
                             rtol=LOSS_RTOL)


def _printed(log: str) -> list:
  return [line for line in log.splitlines()
          if re.match(r"(rollout|collect|train|dryrun_multichip OK):", line)]


def test_only_rank_zero_prints_the_four_lines(runs):
  want, ranks, logs = runs
  lines = _printed(logs[0])
  assert len(lines) == 4, logs[0][-4000:]
  assert not any(_printed(log) for log in logs[1:])
  assert lines[1] == "collect: windows={} lidar={} {}".format(
      want["windows"], want["lidar_shape"], want["lidar_dtype"])
  assert lines[3].startswith("dryrun_multichip OK: mesh=(2x2), ")
  assert lines[3].endswith("loss={:.3f}".format(ranks[0]["loss"]))
