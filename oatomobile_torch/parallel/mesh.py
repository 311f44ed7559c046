"""The device mesh over ``torch.distributed``: the port of the JAX
package's ``parallel/mesh.py``.

The JAX mesh is one controller over many devices, and a sharded array is
one global value.  The port takes PyTorch's idiom instead: one process per
card (``torchrun --nproc_per_node=N``), a process group, and a
``DeviceMesh`` whose dims are named ``("dp", "mp")``.  Three rules hold it
to the JAX semantics:

  - every rank computes what the JAX program computes for its shard;
  - a value that JAX returns as a global array is the same global value on
    every rank (``gather_batch``, ``gather_ensemble``);
  - anything written to disk is written once (``is_main``).

Rank ``r`` sits at ``(r // mp, r % mp)``, the cell of ``devices[r]`` in
the JAX grid ``devices.reshape(n_data, n_model)``.  With no process group
and a world of one, ``make_mesh`` returns a 1x1 mesh on which every helper
is a no-op, as the JAX mesh degenerates on one chip.

Random draws of a sharded update are made at the global batch's shape and
this rank's rows kept (``draw_rows``), so that a sharded run draws the
numbers of the unsharded run and of the JAX package's global arrays.
"""

import contextlib
import contextvars
import dataclasses
import datetime
import os
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from oatomobile_torch import device as device_lib

DATA_AXIS = "dp"
MODEL_AXIS = "mp"
# How long a collective or the group's start may wait for the other ranks.
TIMEOUT = datetime.timedelta(minutes=10)


@dataclasses.dataclass(frozen=True)
class Mesh:
  """A ``(dp, mp)`` mesh of ranks, one card (or CPU process) each.

  ``shape`` maps the axis names to their sizes (as ``jax.sharding.Mesh
  .shape``); ``rank`` is this process's rank in the world and ``device``
  its device; ``device_mesh`` is the ``torch.distributed.DeviceMesh``
  over the world, None on the 1x1 mesh without a process group."""
  shape: Dict[str, int]
  rank: int
  device: torch.device
  device_mesh: Optional[object] = None

  @property
  def size(self) -> int:
    return self.shape[DATA_AXIS] * self.shape[MODEL_AXIS]

  def coordinate(self, axis: str) -> int:
    """This rank's index along ``axis``."""
    mp = self.shape[MODEL_AXIS]
    return self.rank // mp if axis == DATA_AXIS else self.rank % mp

  def group(self, axis: str):
    """The process group of the ranks that share this rank's other
    coordinate (None on the 1x1 mesh without a process group)."""
    if self.device_mesh is None:
      return None
    return self.device_mesh.get_group(axis)


def world_size() -> int:
  """The process group's size, else ``WORLD_SIZE`` (torchrun's), else 1."""
  if dist.is_available() and dist.is_initialized():
    return dist.get_world_size()
  return int(os.environ.get("WORLD_SIZE", "1"))


def is_main() -> bool:
  """True on the rank that writes files: rank 0, or the only process."""
  return not (dist.is_available() and dist.is_initialized()) or \
      dist.get_rank() == 0


def _rank_device(device) -> torch.device:
  """``device`` with this rank's card: ``cuda`` becomes
  ``cuda:{LOCAL_RANK}``, which becomes the current device."""
  device = device_lib.resolve(device)
  if device.type == "cuda":
    if device.index is None:
      device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    torch.cuda.set_device(device)
  return device


def make_mesh(n_data: Optional[int] = None,
              n_model: int = 1,
              devices: Optional[Sequence[int]] = None,
              device="cuda") -> Mesh:
  """A ``(dp, mp)`` mesh over the world.

  With a process group up (the caller's, or torchrun's environment, from
  which it starts one: NCCL on a card, gloo on the CPU) the mesh covers
  every rank; ``devices`` lists the ranks in mesh order (default: the
  world in order), and ``n_data * n_model`` must be the world's size.
  With no process group and a world of one it is the 1x1 mesh.  When
  ``WORLD_SIZE`` says more than one but the group cannot start, it raises
  (the start's own error); it never carries on as a world of one.

  ``device``: this rank's device; ``"cuda"`` (the default) is
  ``cuda:{LOCAL_RANK}`` and raises without a card.
  """
  device = _rank_device(device)
  if not dist.is_initialized():
    if world_size() > 1:
      dist.init_process_group(
          backend="nccl" if device.type == "cuda" else "gloo",
          init_method="env://", timeout=TIMEOUT)
    else:
      if (n_data or 1) * n_model != 1:
        raise ValueError("a {} x {} mesh needs a process group of that "
                         "size".format(n_data, n_model))
      return Mesh({DATA_AXIS: 1, MODEL_AXIS: 1}, 0, device)
  world = dist.get_world_size()
  devices = list(range(world) if devices is None else devices)
  if n_data is None:
    n_data = len(devices) // n_model
  if n_data * n_model != world or sorted(devices) != list(range(world)):
    raise ValueError("a mesh covers the world once: {} x {} over ranks {} "
                     "of a world of {}".format(n_data, n_model, devices,
                                               world))
  from torch.distributed.device_mesh import DeviceMesh  # pylint: disable=import-outside-toplevel
  device_mesh = DeviceMesh(
      device.type, torch.tensor(devices).reshape(n_data, n_model),
      mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
  return Mesh({DATA_AXIS: n_data, MODEL_AXIS: n_model},
              devices.index(dist.get_rank()), device, device_mesh)


def batch_sharding(mesh: Mesh) -> Tuple:
  """The placements of arrays whose leading axis is the scene/batch axis:
  sharded over ``dp``, replicated over ``mp`` (DTensor's placements)."""
  del mesh
  from torch.distributed.tensor import Replicate, Shard  # pylint: disable=import-outside-toplevel
  return (Shard(0), Replicate())


def ensemble_sharding(mesh: Mesh) -> Tuple:
  """The placements of stacked ensemble members (leading member axis):
  replicated over ``dp``, sharded over ``mp``."""
  del mesh
  from torch.distributed.tensor import Replicate, Shard  # pylint: disable=import-outside-toplevel
  return (Replicate(), Shard(0))


def replicated(mesh: Mesh) -> Tuple:
  """The placements of a value replicated over the mesh."""
  del mesh
  from torch.distributed.tensor import Replicate  # pylint: disable=import-outside-toplevel
  return (Replicate(), Replicate())


def _tree_map(fn: Callable, tree):
  """``fn`` over the tensor and array leaves of nested dicts, lists,
  tuples and dataclasses; other leaves pass through."""
  if isinstance(tree, (torch.Tensor, np.ndarray)):
    return fn(tree)
  if isinstance(tree, dict):
    return type(tree)((k, _tree_map(fn, v)) for k, v in tree.items())
  if isinstance(tree, (list, tuple)):
    return type(tree)(_tree_map(fn, v) for v in tree)
  if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
    return dataclasses.replace(tree, **{
        f.name: _tree_map(fn, getattr(tree, f.name))
        for f in dataclasses.fields(tree) if f.init})
  return tree


def _rows(total: int, parts: int, index: int) -> Tuple[int, int]:
  if total % parts:
    raise ValueError("a leading axis of {} does not split over {} "
                     "ranks".format(total, parts))
  size = total // parts
  return index * size, (index + 1) * size


def batch_rows(mesh: Mesh, total: int) -> Tuple[int, int]:
  """``[start, stop)`` of this rank's rows of a global batch of
  ``total``."""
  return _rows(total, mesh.shape[DATA_AXIS], mesh.coordinate(DATA_AXIS))


def shard_batch(mesh: Mesh, tree):
  """This rank's rows ``[r*B/n, (r+1)*B/n)`` of every leaf's leading axis
  (``r`` its ``dp`` index, ``n`` the ``dp`` size); scalars pass.  Tensors
  stay where they are.  A leading axis that does not divide raises."""
  if mesh.shape[DATA_AXIS] == 1:
    return tree

  def take(x):
    if x.ndim == 0:
      return x
    start, stop = batch_rows(mesh, x.shape[0])
    return x[start:stop]

  return _tree_map(take, tree)


def shard_ensemble(mesh: Mesh, tree, num_models: int):
  """Leaves whose leading axis is the ensemble's (``num_models``) keep
  this ``mp`` rank's ``num_models / mp`` members; every other tensor
  leaf is replicated from rank 0."""
  mp = mesh.shape[MODEL_AXIS]

  def place(x):
    if x.ndim >= 1 and x.shape[0] == num_models:
      start, stop = _rows(num_models, mp, mesh.coordinate(MODEL_AXIS))
      return x[start:stop]
    return replicate(mesh, x)

  return _tree_map(place, tree)


def _backend(group) -> str:
  return dist.get_backend(group)


def _wire(x: torch.Tensor) -> torch.Tensor:
  """A contiguous tensor of a dtype every backend carries (bool as
  uint8)."""
  x = x.contiguous()
  return x.view(torch.uint8) if x.dtype == torch.bool else x


def _broadcast_(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
  """Broadcasts ``x`` from rank 0 in place.  NCCL carries card tensors
  only: a CPU tensor goes through the rank's card."""
  wire = _wire(x)
  if _backend(None) == "nccl" and wire.device.type != "cuda":
    on_card = wire.to(mesh.device)
    dist.broadcast(on_card, src=0)
    wire.copy_(on_card)
  else:
    dist.broadcast(wire, src=0)
  return x


def replicate(mesh: Mesh, tree):
  """Every tensor leaf broadcast in place from rank 0 over the world (the
  same values on every rank); other leaves pass."""
  if mesh.device_mesh is None or mesh.size == 1:
    return tree

  def put(x):
    return _broadcast_(x, mesh) if isinstance(x, torch.Tensor) else x

  return _tree_map(put, tree)


def _gather(mesh: Mesh, tree, axis: str, dim: int):
  group = mesh.group(axis)
  if group is None:
    return tree
  n = mesh.shape[axis]
  gloo = _backend(group) == "gloo"

  def gather(x):
    if not isinstance(x, torch.Tensor) or x.ndim == 0:
      return x
    wire = _wire(x.movedim(dim, 0))
    if gloo:
      # Gloo gathers CPU tensors only.
      parts = [torch.empty_like(wire, device="cpu") for _ in range(n)]
      dist.all_gather(parts, wire.cpu(), group=group)
      out = torch.cat(parts).to(x.device)
    else:
      out = torch.empty((n * wire.shape[0],) + wire.shape[1:],
                        dtype=wire.dtype, device=wire.device)
      dist.all_gather_into_tensor(out, wire, group=group)
    if x.dtype == torch.bool:
      out = out.view(torch.bool)
    return out.movedim(0, dim)

  return _tree_map(gather, tree)


def gather_batch(mesh: Mesh, tree, dim: int = 0):
  """The global batch on every rank: every tensor leaf all-gathered over
  ``dp`` along ``dim`` in rank order (the counterpart of reading a global
  ``jax.Array``)."""
  return _gather(mesh, tree, DATA_AXIS, dim)


def gather_ensemble(mesh: Mesh, tree):
  """The whole ensemble on every rank: every tensor leaf all-gathered over
  ``mp`` along its leading (member) axis, in member order."""
  return _gather(mesh, tree, MODEL_AXIS, 0)


def all_reduce_sum_(mesh: Mesh, x: torch.Tensor,
                    axis: Optional[str] = None) -> torch.Tensor:
  """Sums ``x`` in place over ``axis``'s group (the world with None)."""
  if mesh.device_mesh is None:
    return x
  dist.all_reduce(x, group=None if axis is None else mesh.group(axis))
  return x


def ensemble_shape(num_models: int, num_devices: int) -> Tuple[int, int]:
  """``(n_data, n_model)`` of ``ensemble_mesh``: ``n_model`` is the
  largest divisor of ``num_models`` that also divides the device count."""
  n_model = 1
  for cand in range(min(num_models, num_devices), 0, -1):
    if num_models % cand == 0 and num_devices % cand == 0:
      n_model = cand
      break
  return num_devices // n_model, n_model


def ensemble_mesh(num_models: int,
                  devices: Optional[Sequence[int]] = None,
                  device="cuda") -> Mesh:
  """A ``(dp, mp)`` mesh whose ``mp`` divides the ensemble axis
  (``ensemble_shape``), so that stacked members shard evenly over ``mp``
  while the batch shards over ``dp``.  A world of one gives the 1x1
  mesh."""
  n = len(devices) if devices is not None else world_size()
  n_data, n_model = ensemble_shape(num_models, n)
  return make_mesh(n_data, n_model, devices, device)


_ROWS = contextvars.ContextVar("oatomobile_torch_batch_rows", default=None)


@contextlib.contextmanager
def global_rows(start: int, stop: int, total: int):
  """Within the block, ``draw_rows`` draws at a leading axis of ``total``
  and keeps rows ``[start, stop)``."""
  token = _ROWS.set((start, stop, total))
  try:
    yield
  finally:
    _ROWS.reset(token)


def draw_rows(draw: Callable, key: torch.Tensor, shape) -> torch.Tensor:
  """``draw(key, shape)``; inside ``global_rows`` (a sharded update) the
  draw is made at the global batch's shape and this rank's rows kept, so
  that every rank draws its rows of the unsharded run's numbers."""
  rows = _ROWS.get()
  if rows is None:
    return draw(key, shape)
  start, stop, total = rows
  shape = tuple(shape)
  if shape[0] != stop - start:
    raise ValueError("a draw of shape {} in a shard of rows [{}, {})".format(
        shape, start, stop))
  return draw(key, (total,) + shape[1:])[start:stop]
