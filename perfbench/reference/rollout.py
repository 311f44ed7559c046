"""The reference's closed-loop rollout: the scene batch of a cell built from
its seed, and the rollout step (policy -> world step -> done -> stats ->
sensors -> auto-reset), eagerly, one op after another.

A frozen copy of the program's step semantics (``envs/batched.py``), with
the reference's own town build, routes, draws, world model and splat.
"""

import dataclasses
from typing import Callable, Dict, Optional, Sequence

import torch

from perfbench.reference import synth
from perfbench.reference import threefry
from perfbench.reference.maps.towns import load_town
from perfbench.reference.sim.autopilot import autopilot_policy
from perfbench.reference.sim.types import (PIDState, SceneState, _map_fields,
                                           clone_state, map_state)
from perfbench.reference.sim.util import norm
from perfbench.reference.sim.world import (init_scene_batch, make_params,
                                           world_step)

PRECISIONS = ("float32", "tf32", "bfloat16")
STAT_DTYPES = {"episodes": torch.int32, "collisions": torch.int32,
               "distance": torch.float32, "obs_checksum": torch.float32}
ARRIVAL_RADIUS_M = 7.5


def _cast(tree, dtype):
  """A state or the world's parameters with every float tensor in
  ``dtype``."""
  return _map_fields(tree, lambda t: t.to(dtype) if t.is_floating_point()
                     else t)


def autopilot(params, state):
  return autopilot_policy(params, state, noise=0.0)


def leaves(state) -> Dict[str, torch.Tensor]:
  """Every tensor of a scene state (the program's or the reference's) by
  its field path, e.g. ``hero_xy`` or ``pid_lat.err_buf``."""
  out = {}
  for f in dataclasses.fields(state):
    value = getattr(state, f.name)
    if isinstance(value, torch.Tensor):
      out[f.name] = value
    else:
      for k, v in leaves(value).items():
        out[f.name + "." + k] = v
  return out


def state_from_leaves(d: Dict[str, torch.Tensor]) -> SceneState:
  """The reference's ``SceneState`` of ``leaves``' dict (copied)."""
  kwargs = {}
  for f in dataclasses.fields(SceneState):
    if f.name in ("pid_lat", "pid_lon"):
      kwargs[f.name] = PIDState(
          err_buf=d[f.name + ".err_buf"].clone(),
          prev_error=d[f.name + ".prev_error"].clone())
    else:
      kwargs[f.name] = d[f.name].clone()
  return SceneState(**kwargs)


class ReferenceEnv:
  """A cell's scene batch and its rollout step."""

  def __init__(self, town: str, batch_size: int, *, num_vehicles: int,
               num_pedestrians: int = 0, route_capacity: int, seed: int,
               max_episode_steps: int = 1500, device="cuda") -> None:
    self.device = torch.device(device)
    self.town = load_town(town)
    self.params = make_params(self.town, device=self.device)
    self.max_episode_steps = int(max_episode_steps)
    self.initial = init_scene_batch(
        self.town, batch_size, num_vehicles=num_vehicles,
        num_pedestrians=num_pedestrians, route_capacity=route_capacity,
        seed=seed, device=self.device)

  def done(self, state: SceneState) -> torch.Tensor:
    reached = norm(state.hero_xy - state.destination_xy) < ARRIVAL_RADIUS_M
    return ((state.collision > 0.0) |
            (state.step >= self.max_episode_steps) | reached)

  def reset_where_done(self, state: SceneState,
                       done: torch.Tensor) -> SceneState:
    """Done scenes restart from the initial state with a key folded from
    the live key and step."""
    fresh = threefry.fold_in(state.rng, state.step)

    def pick(init_leaf, live_leaf):
      d = done.reshape(done.shape + (1,) * (live_leaf.dim() - 1))
      return torch.where(d, init_leaf, live_leaf)

    out = map_state(pick, self.initial, state)
    return out.replace(rng=torch.where(done[:, None], fresh, state.rng))

  def rollout(self, state: SceneState, num_steps: int,
              policy: Optional[Callable] = None,
              compute: Sequence[str] = (), precision: str = "float32"):
    """(final state, episode stats) of ``num_steps`` steps from
    ``state``, in IEEE float32 (TF32 off), or in a lower ``precision``:
    ``"tf32"`` (matrix products and convolutions in TF32) or
    ``"bfloat16"`` (the state and the world's parameters held in bfloat16,
    each step computed from them)."""
    if precision not in PRECISIONS:
      raise ValueError("precision {!r}: one of {}".format(precision,
                                                         PRECISIONS))
    tf32 = precision == "tf32"
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
      final, stats = self._rollout(state, num_steps, policy, compute,
                                   low=precision == "bfloat16")
    finally:
      (torch.backends.cuda.matmul.allow_tf32,
       torch.backends.cudnn.allow_tf32) = flags
    if precision == "bfloat16":
      final = _cast(final, torch.float32)
    return final, stats

  def _rollout(self, state, num_steps, policy, compute, low: bool):
    policy = policy or autopilot
    B = state.batch_size
    params = _cast(self.params, torch.bfloat16) if low else self.params
    stats = {k: torch.zeros(B, dtype=dtype, device=self.device)
             for k, dtype in STAT_DTYPES.items()}
    state = clone_state(state)
    for _ in range(num_steps):
      if low:
        state = _cast(state, torch.bfloat16)
      actions, state = policy(params, state)
      new_state = world_step(params, state, actions)
      done = self.done(new_state)
      if compute:
        obs = synth.synthesize(params, new_state, tuple(compute))
        for v in obs.values():
          stats["obs_checksum"] += v.to(torch.float32).reshape(B, -1).sum(-1)
      stats["episodes"] += done.to(torch.int32)
      stats["collisions"] += (new_state.collision > 0).to(torch.int32)
      stats["distance"] += norm(new_state.hero_xy - state.hero_xy)
      if low:
        new_state = _cast(new_state, torch.bfloat16)
      state = self.reset_where_done(new_state, done)
    return state, stats
