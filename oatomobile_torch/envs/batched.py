"""The batched environment: B scenes stepped together on one device.

Port of the JAX package's ``envs/batched.py``.  Where the JAX class
``vmap``s a one-scene step, ``lax.scan``s it over time and places the
batch on a device mesh, this class steps a ``[B, ...]`` scene batch with
a Python loop over time on one ``device``.  Done scenes are reset on the
device from their initial state, with a fresh key folded from the live
one (unless ``auto_reset=False``, as the collection pipeline asks).
"""

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from oatomobile_torch import device as device_lib
from oatomobile_torch import rng as rng_lib
from oatomobile_torch.maps import load_town
from oatomobile_torch.sensors import synth
from oatomobile_torch.sim import (autopilot_policy, init_scene_batch,
                                  make_params, world_step)
from oatomobile_torch.sim.types import SceneState, map_state
from oatomobile_torch.sim.util import norm
from oatomobile_torch.sim.world import SIMULATOR_FPS


class BatchedEnv:
  """B-way vectorised driving environment on one device."""

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
      mesh: must be None: placing the scenes over several cards is not
        ported yet.
      auto_reset: reset done scenes from their initial state after each
        step; ``False`` leaves them where they ended (collection cuts its
        windows before the first collision).
      device: where the scenes live; ``"cuda"`` unless the caller asks for
        ``"cpu"``.  Raises when it names CUDA and no card is present.
    """
    del route_pool
    if mesh is not None:
      raise NotImplementedError(
          "BatchedEnv(mesh=...): scenes over a device mesh are not ported "
          "to oatomobile_torch yet (one device only)")
    self._device = device_lib.resolve(device)
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
    # The step functions return new tensors and never write into their
    # inputs, so the live state may share the initial state's storage.
    self._state = self._initial

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
  def state(self) -> SceneState:
    return self._state

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

  # -- public API ------------------------------------------------------------

  def reset(self) -> Dict[str, torch.Tensor]:
    self._state = self._initial
    return synth.synthesize(self._params, self._state, self._sensors)

  def step(self, actions) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Steps all scenes; returns (obs dict of [B, ...], done [B])."""
    actions = torch.as_tensor(actions, dtype=torch.float32,
                              device=self._device)
    new_state = world_step(self._params, self._state, actions)
    done = self._done(new_state)
    obs = synth.synthesize(self._params, new_state, self._sensors)
    self._state = self._reset_where_done(new_state, done)
    return obs, done

  def rollout(
      self,
      num_steps: int,
      policy: Optional[Callable] = None,
      collect: Sequence[str] = (),
      compute: Sequence[str] = (),
      collect_transform: Optional[Callable] = None,
  ):
    """Closed-loop rollout on the device: a loop over time of
    (policy -> step -> auto-reset); nothing is fetched to the host.

    Args:
      num_steps: number of steps.
      policy: ``(params, state) -> (action [B, 3], state)``; defaults to the
        autopilot expert.
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
       episode_stats dict of [B] tensors).
    """
    if policy is None:
      def policy(params, state):
        return autopilot_policy(params, state, noise=0.0)

    B, dev = self._batch_size, self._device
    stats = {
        "episodes": torch.zeros(B, dtype=torch.int32, device=dev),
        "collisions": torch.zeros(B, dtype=torch.int32, device=dev),
        "distance": torch.zeros(B, dtype=torch.float32, device=dev),
        "obs_checksum": torch.zeros(B, dtype=torch.float32, device=dev),
    }
    collected = {key: [] for key in collect}
    state = self._state
    for _ in range(num_steps):
      actions, state = policy(self._params, state)
      new_state = world_step(self._params, state, actions)
      done = self._done(new_state)
      if compute:
        obs_c = synth.synthesize(self._params, new_state, tuple(compute))
        for v in obs_c.values():
          # In place: the running sums are the only copies of the stats.
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
    self._state = state
    out = ({key: torch.stack(values) for key, values in collected.items()}
           if collect else ())
    return state, out, stats
