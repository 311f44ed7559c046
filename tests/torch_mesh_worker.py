"""One rank of the port's mesh scenarios on the CPU (gloo).

    python tests/torch_mesh_worker.py RANK WORLD STORE INPUTS OUT [MODE]

``STORE`` is the ``file://`` rendezvous, ``INPUTS`` a ``torch.save`` of
the scenarios' inputs (a pack directory, converted weights, batches, a
key), ``OUT`` the directory where each rank writes ``rank{RANK}.pt``: the
values every scenario returns on this rank.  ``MODE`` is ``scenarios``
(the default: the two-rank scenarios of ``tests/test_torch_mesh.py``) or
``dryrun`` (``oatomobile_torch.entry.dryrun`` with the inputs'
``init_states``, for ``tests/test_torch_entry.py``).  The group's start
and every collective time out after ``TIMEOUT`` seconds, so that a hang
fails instead of waiting.  Imports torch and the port only (no jax);
``spawn`` starts the ranks for the tests, which hold what they return
against the single process and the JAX package.
"""

import datetime
import os
import subprocess
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from oatomobile_torch import rng as rng_lib  # pylint: disable=wrong-import-position
from oatomobile_torch.baselines.learned.cil import train as tcil  # pylint: disable=wrong-import-position
from oatomobile_torch.baselines.learned.dim import train as tdim  # pylint: disable=wrong-import-position
from oatomobile_torch.baselines.learned.rip import train as trip  # pylint: disable=wrong-import-position
from oatomobile_torch.envs.batched import BatchedEnv  # pylint: disable=wrong-import-position
from oatomobile_torch.models import ImitativeModel  # pylint: disable=wrong-import-position
from oatomobile_torch.parallel import dp  # pylint: disable=wrong-import-position
from oatomobile_torch.parallel import mesh as mesh_lib  # pylint: disable=wrong-import-position

TIMEOUT = 60
TOY_STEPS, TOY_LR = 5, 1e-2
ENV = dict(batch_size=8, num_vehicles=2, seed=3)
ENV_STEPS = 10
TRAIN = dict(batch_size=8, num_epochs=1, max_steps_per_epoch=2,
             val_fraction=0.0, device_data=False, device="cpu")


class Toy(torch.nn.Module):
  """``x @ w + b`` with the JAX test's initial values."""

  def __init__(self):
    super().__init__()
    self.w = torch.nn.Parameter(torch.full((8, 4), 0.1))
    self.b = torch.nn.Parameter(torch.zeros(4))


def toy_loss(model, batch, rng):
  del rng
  x, y = (torch.as_tensor(batch[k]) for k in ("x", "y"))
  return torch.mean((x @ model.w + model.b - y)**2)


def toy_run(mesh, batch, grad_accum=1):
  """TOY_STEPS Adam updates of the toy; (losses, w, b)."""
  model = Toy()
  state = dp.TrainState.create(
      model, torch.optim.Adam(model.parameters(), lr=TOY_LR, eps=1e-8),
      rng_lib.PRNGKey(0))
  state = dp.replicate_state(mesh, state)
  update = dp.make_update_fn(toy_loss, grad_accum=grad_accum, mesh=mesh)
  losses = []
  for _ in range(TOY_STEPS):
    state, loss = update(state, batch)
    losses.append(float(loss))
  return losses, model.w.detach().clone(), model.b.detach().clone()


def env_run(mesh):
  """The mesh env's global returns: reset, one step, a 10-step rollout
  collecting the velocity."""
  env = BatchedEnv("Town02", mesh=mesh, device="cpu", **ENV)
  obs0 = env.reset()
  obs1, done1 = env.step(torch.full((ENV["batch_size"], 3), 0.3))
  env.reset()
  final, collected, stats = env.rollout(ENV_STEPS, collect=("velocity",))
  return {"reset_velocity": obs0["velocity"], "step_velocity":
          obs1["velocity"], "step_done": done1, "hero_xy": final.hero_xy,
          "npc_alive": final.npc_alive, "rng": final.rng,
          "collected_velocity": collected["velocity"], **{
              "stats_" + k: v for k, v in stats.items()}}


def dim_update(mesh, inputs):
  """One DIM update on the converted weights: the updated weights, the
  loss and the global gradient of the same shard."""
  model = ImitativeModel((4, 2), inputs["input_size"], device="cpu")
  model.load_state_dict(inputs["dim_weights"])
  loss_fn = tdim.make_loss_fn()
  batch, key = inputs["dim_batch"], rng_lib.from_numpy(inputs["dim_key"])
  # The global gradient, as the update takes it.
  step_key = rng_lib.split(key)[1]
  params = list(model.parameters())
  start, stop = mesh_lib.batch_rows(mesh, 8)
  with mesh_lib.global_rows(start, stop, 8):
    loss = loss_fn(model, mesh_lib.shard_batch(mesh, batch), step_key)
  grads = list(torch.autograd.grad(loss, params))
  dp._all_reduce_mean_(mesh, grads)  # pylint: disable=protected-access
  names = [n for n, _ in model.named_parameters()]
  state = dp.TrainState.create(model, dp.adam(model, 1e-3), key)
  state = dp.replicate_state(mesh, state)
  state, loss = dp.make_update_fn(loss_fn, mesh=mesh)(state, batch)
  return {"loss": float(loss), "grads": dict(zip(names, grads)),
          "state_dict": {k: v.clone() for k, v in
                         model.state_dict().items()}}


def start(world: int, inputs: dict, out: str,
          mode: str = "scenarios") -> list:
  """Starts ``world`` ranks of ``mode`` on ``inputs`` (saved into
  ``out``), each with one thread; returns their processes."""
  path = os.path.join(out, "inputs.pt")
  torch.save(inputs, path)
  store = "file://" + os.path.join(out, "store")
  env = dict(os.environ, OMP_NUM_THREADS="1")
  return [subprocess.Popen(
      [sys.executable, __file__, str(r), str(world), store, path, out, mode],
      env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
          for r in range(world)]


def join(procs: list, join_seconds: float) -> list:
  """Waits for ``start``'s ranks under one timeout of ``join_seconds`` (a
  hung rank fails) and asserts that every rank exited 0; returns each
  rank's output."""
  logs = []
  try:
    for proc in procs:
      logs.append(proc.communicate(timeout=join_seconds)[0].decode())
  finally:
    for proc in procs:
      proc.kill()
  for proc, log in zip(procs, logs):
    assert proc.returncode == 0, log[-4000:]
  return logs


def results(out: str, world: int) -> list:
  """What each rank of a finished ``spawn`` saved, in rank order."""
  return [torch.load(os.path.join(out, "rank{}.pt".format(r)),
                     weights_only=False) for r in range(world)]


def scenarios(inputs, out) -> dict:
  """Every two-rank scenario of ``tests/test_torch_mesh.py``."""
  found = {}
  mesh = mesh_lib.make_mesh(device="cpu")
  found["mesh"] = (mesh.shape, mesh.rank, mesh.coordinate("dp"))
  found["toy"] = toy_run(mesh, inputs["toy_batch"])
  found["toy_accum"] = toy_run(mesh, inputs["toy_batch"], grad_accum=2)
  found["env"] = env_run(mesh)
  found["dim_update"] = dim_update(mesh, inputs)
  pack = inputs["pack"]
  found["dim_train"] = tdim.train(
      pack, os.path.join(out, "dim"), use_mesh=True, plot_every=0,
      input_size=inputs["input_size"], **TRAIN).model.state_dict()
  found["cil_train"] = tcil.train(
      pack, os.path.join(out, "cil"), use_mesh=True,
      **TRAIN).model.state_dict()
  rip_mesh = mesh_lib.ensemble_mesh(4, device="cpu")
  found["rip_mesh"] = (rip_mesh.shape, rip_mesh.coordinate("mp"))
  found["rip_train"] = trip.stack_params(trip.train(
      pack, os.path.join(out, "rip"), num_models=4, use_mesh=True,
      save_model_frequency=1, **TRAIN))
  return found


def main() -> None:
  rank, world = int(sys.argv[1]), int(sys.argv[2])
  store, inputs_path, out = sys.argv[3:6]
  mode = sys.argv[6] if len(sys.argv) > 6 else "scenarios"
  torch.set_num_threads(1)
  dist.init_process_group("gloo", init_method=store, rank=rank,
                          world_size=world,
                          timeout=datetime.timedelta(seconds=TIMEOUT))
  inputs = torch.load(inputs_path, weights_only=False)
  if mode == "dryrun":
    from oatomobile_torch import entry  # pylint: disable=import-outside-toplevel
    found = entry.dryrun(device="cpu", init_states=inputs.get("init_states"))
  else:
    found = scenarios(inputs, out)
  torch.save(found, os.path.join(out, "rank{}.pt".format(rank)))
  dist.barrier()
  dist.destroy_process_group()


if __name__ == "__main__":
  main()
