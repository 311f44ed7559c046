"""The batched environment: B scenes stepped together, on one device or
over a mesh of ranks.

Port of the JAX package's ``envs/batched.py``.  Where the JAX class
``vmap``s a one-scene step, ``lax.scan``s it over time and places the
batch on a device mesh, this class steps a ``[B, ...]`` scene batch on one
``device``.  Done scenes are reset on the device from their initial
state, with a fresh key folded from the live one (unless
``auto_reset=False``, as the collection pipeline asks).

With a ``mesh`` (``parallel.mesh``) every rank builds the whole batch from
the seed and keeps its ``dp`` rows, so scene i is the same scene on
whichever rank it lives; each rank steps (and captures) its ``B / n``
scenes with no collective, since scenes are independent, and the values
the JAX class returns as global arrays (``state``, the observations and
done flags of ``reset`` and ``step``, ``rollout``'s returns) are gathered
once a call, the same global value on every rank.

The JAX package jits its step and its rollout's scan with the state
donated.  Here one step (policy -> world step -> done -> stats -> sensors
-> auto-reset) reads the live state, the stats and the key from static
buffers and writes the next state back into them; on a card it is
captured once per rollout configuration into a CUDA graph and replayed
once a step (``graphs.CapturedStep``), on the CPU it runs eagerly.
"""

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from oatomobile_torch import device as device_lib
from oatomobile_torch import graphs
from oatomobile_torch import rng as rng_lib
from oatomobile_torch.maps import load_town
from oatomobile_torch.parallel import mesh as mesh_lib
from oatomobile_torch.sensors import synth
from oatomobile_torch.sim import (autopilot_policy, init_scene_batch,
                                  make_params, world_step)
from oatomobile_torch.sim.types import (SceneState, clone_state, copy_state_,
                                        map_state)
from oatomobile_torch.sim.util import norm
from oatomobile_torch.sim.world import SIMULATOR_FPS
from oatomobile_torch.utils import profiling

STAT_DTYPES = {"episodes": torch.int32, "collisions": torch.int32,
               "distance": torch.float32, "obs_checksum": torch.float32}


def _autopilot(params, state):
  return autopilot_policy(params, state, noise=0.0)


class BatchedEnv:
  """B-way vectorised driving environment on one device or a mesh."""

  def __init__(
      self,
      town: str,
      batch_size: int,
      sensors: Sequence[str] = synth.STATE_SENSORS,
      num_vehicles: int = 0,
      num_pedestrians: int = 0,
      fps: int = SIMULATOR_FPS,
      max_episode_steps: int = 1500,
      route_capacity: int = 512,
      route_pool: Optional[int] = None,
      seed: int = 0,
      mesh=None,
      auto_reset: bool = True,
      device="cuda",
  ) -> None:
    """Args:
      route_pool: unused, kept for the JAX package's signature (the
        batched route planner makes per-scene routes).
      mesh: a ``parallel.mesh.Mesh``: this rank steps its ``dp`` rows of
        the batch on the mesh's device (``device`` is not read), and the
        returns are global (module docstring).  ``batch_size`` must
        divide over ``dp``.
      auto_reset: reset done scenes from their initial state after each
        step; ``False`` leaves them where they ended (collection cuts its
        windows before the first collision).
      device: where the scenes live; ``"cuda"`` unless the caller asks for
        ``"cpu"``.  Raises when it names CUDA and no card is present.
    """
    del route_pool
    self._mesh = mesh
    self._device = (mesh.device if mesh is not None else
                    device_lib.resolve(device))
    self._town = load_town(town)
    self._params = make_params(self._town, fps=fps, device=self._device)
    self._batch_size = int(batch_size)
    self._sensors = tuple(sorted(set(sensors)))
    self._max_episode_steps = int(max_episode_steps)
    self._auto_reset = auto_reset

    self._initial = init_scene_batch(
        self._town,
        batch_size,
        num_vehicles=num_vehicles,
        num_pedestrians=num_pedestrians,
        route_capacity=route_capacity,
        seed=seed,
        device=self._device,
    )
    if mesh is not None:
      self._initial = clone_state(mesh_lib.shard_batch(mesh, self._initial))
    # This rank's scenes (all of them without a mesh).
    self._local_batch = self._initial.batch_size
    # The static buffers every step reads and writes in place: the live
    # state (a copy, so that auto-reset always finds the pristine initial
    # state), the rollout stats and step()'s actions.
    self._state = clone_state(self._initial)
    self._stats = {k: torch.zeros(self._local_batch, dtype=dtype,
                                  device=self._device)
                   for k, dtype in STAT_DTYPES.items()}
    self._actions = torch.zeros((self._local_batch, 3), dtype=torch.float32,
                                device=self._device)
    self._pool = graphs.new_pool(self._device)
    self._step_fn = None
    # (collect, compute, id(policy), id(collect_transform)) -> (policy,
    # collect_transform, step): the values hold the policy and transform,
    # so an id() cannot be recycled while its step is alive.
    self._rollout_cache: Dict = {}

  # -- properties ---------------------------------------------------------

  @property
  def batch_size(self) -> int:
    return self._batch_size

  @property
  def device(self) -> torch.device:
    return self._device

  @property
  def params(self):
    return self._params

  @property
  def mesh(self):
    return self._mesh

  @property
  def state(self) -> SceneState:
    """A copy of the live state (the next step overwrites the live one);
    the whole batch on every rank under a mesh."""
    return self._global(clone_state(self._state))

  def _global(self, tree, dim: int = 0):
    """``tree`` of this rank's scenes as the whole batch's (along
    ``dim``)."""
    if self._mesh is None:
      return tree
    return mesh_lib.gather_batch(self._mesh, tree, dim)

  # -- core semantics -------------------------------------------------------

  def _done(self, state: SceneState) -> torch.Tensor:
    """[B] done: collision, horizon, or destination reached."""
    reached = norm(state.hero_xy - state.destination_xy) < 7.5
    return ((state.collision > 0.0) |
            (state.step >= self._max_episode_steps) | reached)

  def _reset_where_done(self, state: SceneState,
                        done: torch.Tensor) -> SceneState:
    """On-device auto-reset: scenes flagged done restart from their initial
    state with a fresh RNG stream, folded from the LIVE key so that reset
    streams chain (folding from the initial key would replay one episode
    forever for scenes whose episodes always end at the same step).  The
    state as it is without ``auto_reset``."""
    if not self._auto_reset:
      return state
    fresh = rng_lib.fold_in(state.rng, state.step)

    def pick(init_leaf, live_leaf):
      d = done.reshape(done.shape + (1,) * (live_leaf.dim() - 1))
      return torch.where(d, init_leaf, live_leaf)

    reset_state = map_state(pick, self._initial, state)
    return reset_state.replace(
        rng=torch.where(done[:, None], fresh, state.rng))

  def _make_rollout_step(self, policy: Callable, collect: Tuple[str, ...],
                         compute: Tuple[str, ...],
                         collect_transform: Optional[Callable]):
    """One rollout step on the static buffers: policy -> world step ->
    sensors -> done, stats and auto-reset, the next state written into
    the live state's buffers.  Returns the collected observations (after
    ``collect_transform``), an empty dict when nothing is collected.

    Each part is a span with device marks (``utils.profiling``):
    ``autopilot`` (the expert; a ``DimPolicy`` marks its own stages),
    ``world_step``, ``sensors`` (the ``compute`` and ``collect``
    synthesis) and ``bookkeeping``, under ``step``."""
    params, state, stats, B = (self._params, self._state, self._stats,
                               self._local_batch)
    dev = self._device
    span = profiling.span

    def act():
      if policy is not _autopilot:
        return policy(params, state)
      with span("autopilot", dev):
        return policy(params, state)

    def step():
      with span("step"):
        actions, live = act()
        with span("world_step", dev):
          new_state = world_step(params, live, actions)
        obs = {}
        if compute or collect:
          with span("sensors", dev):
            if compute:
              obs_c = synth.synthesize(params, new_state, compute)
              for v in obs_c.values():
                stats["obs_checksum"] += v.to(torch.float32).reshape(
                    B, -1).sum(-1)
            if collect:
              obs = synth.synthesize(params, new_state, collect)
              if collect_transform is not None:
                obs = collect_transform(obs)
        with span("bookkeeping", dev):
          done = self._done(new_state)
          stats["episodes"] += done.to(torch.int32)
          stats["collisions"] += (new_state.collision > 0).to(torch.int32)
          stats["distance"] += norm(new_state.hero_xy - live.hero_xy)
          copy_state_(state, self._reset_where_done(new_state, done))
        return obs

    return graphs.CapturedStep(step, self._device, pool=self._pool)

  def _fused_step(self):
    """``step``'s work on the static buffers: world step with the actions
    buffer, done, the env's sensors, auto-reset."""
    new_state = world_step(self._params, self._state, self._actions)
    done = self._done(new_state)
    obs = synth.synthesize(self._params, new_state, self._sensors)
    copy_state_(self._state, self._reset_where_done(new_state, done))
    return obs, done

  # -- public API ------------------------------------------------------------

  def reset(self) -> Dict[str, torch.Tensor]:
    copy_state_(self._state, self._initial)
    return self._global(synth.synthesize(self._params,
                                         clone_state(self._state),
                                         self._sensors))

  def step(self, actions) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Steps all scenes with ``actions`` [B, 3] (the whole batch's, under
    a mesh too); returns (obs dict of [B, ...], done [B])."""
    actions = torch.as_tensor(actions, dtype=torch.float32,
                              device=self._device)
    if self._mesh is not None:
      actions = mesh_lib.shard_batch(self._mesh, actions)
    self._actions.copy_(actions)
    if self._step_fn is None:
      self._step_fn = graphs.CapturedStep(self._fused_step, self._device,
                                          pool=self._pool)
    obs, done = self._step_fn()
    return self._global(({k: v.clone() for k, v in obs.items()},
                         done.clone()))

  def rollout(
      self,
      num_steps: int,
      policy: Optional[Callable] = None,
      collect: Sequence[str] = (),
      compute: Sequence[str] = (),
      collect_transform: Optional[Callable] = None,
  ):
    """Closed-loop rollout on the device: ``num_steps`` steps of (policy
    -> step -> auto-reset); nothing is fetched to the host.  On a card the
    step is captured into a CUDA graph at the first rollout of each
    (collect, compute, policy, collect_transform) and replayed once a
    step.  Spans (``utils.profiling``): ``rollout.chunk`` around the call,
    ``rollout.issue`` around the steps (with device marks before the
    first and after the last) and ``rollout.gather`` around the copies
    returned.

    Args:
      num_steps: number of steps.
      policy: ``(params, state) -> (action [B, 3], state)``; defaults to the
        autopilot expert.  It must not fetch tensors to the host or keep
        them between calls: on a card it runs inside the capture.
      collect: observation keys stacked over time and returned ([T, B, ...]
        each); leave empty for pure throughput.
      compute: observation keys synthesised every step but not stored;
        their per-scene sum feeds ``stats["obs_checksum"]``, so a
        throughput run really computes them.
      collect_transform: optional fn applied to each step's obs dict
        before it is stacked over time, e.g. a resize and uint8
        quantisation of the images so that the [T, B, ...] stack stays
        small.

    Returns:
      (final_state, collected dict (or () when nothing is collected),
       episode_stats dict of [B] tensors), each the caller's own copy and
      the whole batch's on every rank under a mesh (gathered once, after
      the last step).
    """
    collect, compute = tuple(collect), tuple(compute)
    key = (collect, compute, None if policy is None else id(policy),
           None if collect_transform is None else id(collect_transform))
    if key not in self._rollout_cache:
      self._rollout_cache[key] = (policy, collect_transform,
                                  self._make_rollout_step(
                                      policy or _autopilot, collect, compute,
                                      collect_transform))
    step = self._rollout_cache[key][2]

    with profiling.span("rollout.chunk"):
      out = {}
      with profiling.span("rollout.issue", self._device, count=num_steps):
        for v in self._stats.values():
          v.zero_()
        for t in range(num_steps):
          obs = step()
          if t == 0:
            out = {k: torch.empty((num_steps,) + v.shape, dtype=v.dtype,
                                  device=v.device) for k, v in obs.items()}
          for k, v in obs.items():
            out[k][t].copy_(v)
      with profiling.span("rollout.gather"):
        stats = self._global({k: v.clone() for k, v in self._stats.items()})
        return (self.state, (self._global(out, 1) if collect else ()),
                stats)

  def _rollout_eager(
      self,
      num_steps: int,
      policy: Optional[Callable] = None,
      collect: Sequence[str] = (),
      compute: Sequence[str] = (),
      collect_transform: Optional[Callable] = None,
  ):
    """``rollout`` as a plain loop that launches every op from the host
    and writes no buffer until it ends: the yardstick that tests and
    ``chip_smoke.py`` hold the captured step against."""
    policy = policy or _autopilot
    B, dev = self._local_batch, self._device
    stats = {k: torch.zeros(B, dtype=dtype, device=dev)
             for k, dtype in STAT_DTYPES.items()}
    collected = {key: [] for key in collect}
    state = clone_state(self._state)
    for _ in range(num_steps):
      actions, state = policy(self._params, state)
      new_state = world_step(self._params, state, actions)
      done = self._done(new_state)
      if compute:
        obs_c = synth.synthesize(self._params, new_state, tuple(compute))
        for v in obs_c.values():
          stats["obs_checksum"] += v.to(torch.float32).reshape(B, -1).sum(-1)
      stats["episodes"] += done.to(torch.int32)
      stats["collisions"] += (new_state.collision > 0).to(torch.int32)
      stats["distance"] += norm(new_state.hero_xy - state.hero_xy)
      if collect:
        obs = synth.synthesize(self._params, new_state, tuple(collect))
        if collect_transform is not None:
          obs = collect_transform(obs)
        for key, value in obs.items():
          collected[key].append(value)
      state = self._reset_where_done(new_state, done)
    copy_state_(self._state, state)
    out = ({key: torch.stack(values) for key, values in collected.items()}
           if collect else ())
    return (self._global(state), self._global(out, 1) if collect else (),
            self._global(stats))
