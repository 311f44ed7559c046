"""The repository's entry points: a capturable DIM loss and the whole
pipeline's dry run over a mesh.  Port of the repository's
``__graft_entry__.py``.

    python -m oatomobile_torch.entry [--cpu]
    torchrun --nproc_per_node=2 -m oatomobile_torch.entry --cpu

- ``entry()``: ``(fn, example_args)``, the Deep Imitative Model's NLL
  forward (MobileNetV2 encoder + autoregressive flow) as a function pure
  in its parameters (``torch.func.functional_call``); ``capture(fn,
  example_args)`` runs it as a ``graphs.CapturedStep`` replay, the
  counterpart of ``jax.jit``.
- ``dryrun(mesh)``: the counterpart of ``dryrun_multichip(n)``.  Three
  phases on one ``(dp, mp)`` mesh of ``torch.distributed`` ranks
  (``parallel.mesh``): a dp-sharded closed-loop ``BatchedEnv`` rollout
  with the LIDAR and the state sensors collected on the device; the
  rollout's windows packed on the device (``datasets.carla.
  _device_pack_windows``: gather, world->ego transform, resize,
  quantise); one Adam step of an ensemble of DIMs, the batch over ``dp``
  and the members over ``mp``, whose loss is the members' mean NLL.

The command line computes ``entry``'s loss, then runs ``dryrun`` over the
world ``torchrun`` gives it (NCCL on cards, gloo with ``--cpu``), or over
a world of one.  Rank 0 prints.
"""

import argparse
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from oatomobile_torch import device as device_lib
from oatomobile_torch import graphs
from oatomobile_torch import rng as rng_lib
from oatomobile_torch.models.dim import ImitativeModel
from oatomobile_torch.parallel import dp
from oatomobile_torch.parallel import mesh as mesh_lib

OUTPUT_SHAPE = (4, 2)
ENTRY_BATCH = 2
IMAGE_SIZE = (100, 100)
# The dry run: Town02, 2 scenes per dp rank, 2 NPCs; 115 steps hold one
# past-20 / future-80 window per scene every 5 steps (3 of them).
TOWN, SCENES_PER_DP, VEHICLES = "Town02", 2, 2
ROLLOUT_STEPS = 115
PAST, FUTURE, FRAME_SKIP = 20, 80, 5
MODALITIES = ("lidar", "velocity", "is_at_traffic_light",
              "traffic_light_state")
COLLECT = MODALITIES + ("location", "rotation", "collision")
LEARNING_RATE = 1e-3
CONTEXT = ("visual_features", "velocity", "is_at_traffic_light",
           "traffic_light_state")


class NLL(ImitativeModel):
  """``ImitativeModel`` whose ``forward`` is ``-mean(log_prob)`` of NHWC
  visual features, as the JAX entry's ``fn`` applies the flax model."""

  def forward(self, y, visual_features, velocity, is_at_traffic_light,
              traffic_light_state):
    return -torch.mean(self.log_prob(
        y, visual_features=visual_features.movedim(-1, -3),
        velocity=velocity, is_at_traffic_light=is_at_traffic_light,
        traffic_light_state=traffic_light_state))


def _context(batch: int, device, size: int = IMAGE_SIZE[0]):
  zeros = lambda *shape: torch.zeros(shape, device=device)  # pylint: disable=unnecessary-lambda-assignment
  return dict(visual_features=zeros(batch, size, size, 2),
              velocity=zeros(batch, 3),
              is_at_traffic_light=zeros(batch, 1),
              traffic_light_state=zeros(batch, 1))


def entry(device="cuda") -> Tuple[Callable, tuple]:
  """``(fn, example_args)``: ``fn(params, y, visual_features, velocity,
  is_at_traffic_light, traffic_light_state)`` is ``-mean(log_prob)`` of
  ``ImitativeModel((4, 2))`` with the parameters ``params`` (its
  ``state_dict`` keys); the example's weights come from
  ``torch.Generator().manual_seed(0)``, its inputs are zeros at batch 2
  (visual features NHWC, as the JAX entry's)."""
  device = device_lib.resolve(device)
  model = NLL(OUTPUT_SHAPE, IMAGE_SIZE,
              generator=torch.Generator().manual_seed(0), device=device)
  params = dict(model.state_dict())
  ctx = _context(ENTRY_BATCH, device)
  y = torch.zeros((ENTRY_BATCH,) + OUTPUT_SHAPE, device=device)

  def fn(params, y, visual_features, velocity, is_at_traffic_light,
         traffic_light_state):
    return torch.func.functional_call(
        model, params, (y, visual_features, velocity, is_at_traffic_light,
                        traffic_light_state))

  return fn, (params, y) + tuple(ctx[k] for k in CONTEXT)


def capture(fn: Callable, example_args: Sequence) -> Callable:
  """``fn`` as a captured step on static copies of ``example_args``
  (``(params, *inputs)``): each call copies its arguments (of the
  example's names and shapes) into them and runs ``graphs.CapturedStep``
  (on a card two eager warm-up calls, then one capture, then one replay a
  call; on the CPU eager); returns a copy of the output."""
  params, *inputs = example_args
  static_params = {k: v.detach().clone() for k, v in params.items()}
  static_inputs = [x.detach().clone() for x in inputs]
  device = static_inputs[0].device
  step = graphs.CapturedStep(lambda: fn(static_params, *static_inputs),
                             device, pool=graphs.new_pool(device))

  def run(params, *inputs):
    if params.keys() != static_params.keys():
      raise ValueError("the parameters' names differ from the example's")
    for name, value in params.items():
      static_params[name].copy_(value)
    for dst, src in zip(static_inputs, inputs):
      dst.copy_(src)
    return step().clone()

  return run


# -- the dry run -------------------------------------------------------------------


def dryrun_mesh(device="cuda") -> mesh_lib.Mesh:
  """The dry run's ``(dp, mp)`` mesh over the world: ``mp`` 2 when the
  world's size is even, else 1 (the JAX function's rule); a world of one
  without a process group is the 1x1 mesh."""
  world = mesh_lib.world_size()
  n_model = 2 if world % 2 == 0 else 1
  return mesh_lib.make_mesh(world // n_model, n_model, device=device)


def _flat(x: torch.Tensor) -> torch.Tensor:
  """``[C, B, ...]`` windows -> ``[B * C, ...]``, episode-major."""
  x = x.transpose(0, 1)
  return x.reshape((-1,) + tuple(x.shape[2:]))


def _placements(placements) -> str:
  return "({})".format(", ".join(str(p) for p in placements))


def ensemble_loss_fn(num_models: int):
  """``(members, batch, rng) -> loss``: the mean over the ``num_models``
  members of each one's NLL of ``batch["y"]``, no noise and no velocity
  dropout (the JAX dry run's loss).  ``members`` may be an ``mp`` shard of
  the ensemble: the loss is then their share of the mean, their NLLs' sum
  over ``num_models``, as ``rip.train.make_loss_fn`` takes it, and the
  update's sum over the world makes it the mean."""

  def loss_fn(members, batch, rng):
    del rng
    nll = torch.stack([member(batch["y"], *(batch[k] for k in CONTEXT))
                       for member in members])
    if len(members) == num_models:
      return nll.mean()
    return nll.sum() / num_models

  return loss_fn


def dryrun(mesh: Optional[mesh_lib.Mesh] = None, *, device="cuda",
           init_states: Optional[Sequence[Dict[str, torch.Tensor]]] = None
           ) -> dict:
  """The whole pipeline on ``mesh`` (default ``dryrun_mesh(device)``):
  rollout -> packed windows -> one ensemble Adam step (module docstring).

  Every rank builds the whole scene batch and steps its ``dp`` rows; the
  rollout's returns are the global batch on every rank (``BatchedEnv``'s
  gather), so the packed windows, the counts and the loss are global.
  The ensemble has ``2 * mp`` members, member k drawn from
  ``torch.Generator().manual_seed(k)`` or loaded from ``init_states[k]``
  (a ``state_dict``); each ``mp`` rank keeps and steps its ``2`` members.
  Plain Adam at 1e-3, no clipping.  Rank 0 prints the JAX function's four
  lines, with the port's placements where JAX prints a PartitionSpec.

  Returns the printed numbers: ``scenes``, ``mesh`` ``(dp, mp)``,
  ``windows`` and ``batch`` (both the global count of windows),
  ``lidar_shape`` (the packed LIDAR's global ``[C, B, 100, 100, 2]``),
  ``lidar_dtype``, ``ensemble`` and ``loss``.
  """
  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.datasets.carla import _device_pack_windows
  from oatomobile_torch.envs.batched import BatchedEnv

  if mesh is None:
    mesh = dryrun_mesh(device)
  n_data, n_model = mesh.shape[mesh_lib.DATA_AXIS], mesh.shape[
      mesh_lib.MODEL_AXIS]
  ensemble = 2 * n_model
  if init_states is not None and len(init_states) != ensemble:
    raise ValueError("{} initial states for an ensemble of {}".format(
        len(init_states), ensemble))
  main = mesh_lib.is_main()
  say = print if main else (lambda *args: None)

  # -- 1. The dp-sharded closed-loop rollout.
  scenes = SCENES_PER_DP * n_data
  env = BatchedEnv(TOWN, scenes, num_vehicles=VEHICLES, seed=0, mesh=mesh,
                   auto_reset=False)
  _, collected, stats = env.rollout(ROLLOUT_STEPS, collect=COLLECT)
  say("rollout: scenes={} sharding={}".format(
      scenes, _placements(mesh_lib.batch_sharding(mesh))))
  if not float(stats["distance"].sum()) > 0.0:
    raise RuntimeError("the dry run's scenes did not move")

  # -- 2. The packed windows, on the device.
  packed = _device_pack_windows(collected, MODALITIES, PAST, FUTURE,
                                FRAME_SKIP, IMAGE_SIZE)
  del collected
  batch = int(packed["player_future"].shape[0]) * scenes
  lidar_shape = tuple(packed["lidar"].shape)
  lidar_dtype = str(packed["lidar"].dtype).replace("torch.", "")
  say("collect: windows={} lidar={} {}".format(batch, lidar_shape,
                                              lidar_dtype))
  data = {"y": _flat(packed["player_future"])[..., :2][:, ::20][:, :4],
          "visual_features": _flat(packed["lidar"]).to(torch.float32) / 255.0}
  for key in CONTEXT[1:]:
    data[key] = _flat(packed[key]).to(torch.float32)

  # -- 3. One ensemble step: the batch over dp, the members over mp.
  per = ensemble // n_model
  first = mesh.coordinate(mesh_lib.MODEL_AXIS) * per
  members = nn.ModuleList()
  for k in range(first, first + per):
    member = NLL(OUTPUT_SHAPE, IMAGE_SIZE,
                 generator=torch.Generator().manual_seed(k),
                 device=mesh.device)
    if init_states is not None:
      member.load_state_dict(init_states[k], strict=True)
    members.append(member)
  update = dp.make_update_fn(ensemble_loss_fn(ensemble), mesh=mesh)
  state = dp.TrainState.create(members, dp.adam(members, LEARNING_RATE),
                               rng_lib.PRNGKey(0, mesh.device))
  state, loss = update(state, data)
  loss = float(loss)
  if not math.isfinite(loss):
    raise RuntimeError("non-finite loss in the dry run")
  say("train: params sharding={} batch sharding={}".format(
      _placements(mesh_lib.ensemble_sharding(mesh)),
      _placements(mesh_lib.batch_sharding(mesh))))
  say("dryrun_multichip OK: mesh=({}x{}), rollout->collect->train, "
      "ensemble={}, batch={}, loss={:.3f}".format(n_data, n_model, ensemble,
                                                 batch, loss))
  return {"scenes": scenes, "mesh": (n_data, n_model), "windows": batch,
          "lidar_shape": lidar_shape, "lidar_dtype": lidar_dtype,
          "ensemble": ensemble, "batch": batch, "loss": loss}


def main(argv=None) -> None:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--cpu", action="store_true",
                      help="run on the CPU (default: the CUDA card)")
  args = parser.parse_args(argv)
  started = not dist.is_initialized()
  mesh = dryrun_mesh("cpu" if args.cpu else "cuda")
  try:
    fn, example = entry(mesh.device)
    loss = float(capture(fn, example)(*example))
    if mesh_lib.is_main():
      print("entry loss:", loss)
    dryrun(mesh)
  finally:
    if started and dist.is_initialized():
      dist.destroy_process_group()


if __name__ == "__main__":
  main()
