"""The DIM driving policy for batched rollouts: port of the JAX package's
``baselines/learned/dim/policy.py``.

Each step: BEV synthesis (one splat kernel launch), the MobileNetV2
context encoder, ``num_plan_steps`` Adam steps of the flow planner, and
the plan -> control bridge.  The policy is a ``BatchedEnv.rollout``
policy; its four stages are methods, and a call marks each on the device
clock as the span ``dim.observe``, ``dim.encode``, ``dim.plan`` or
``dim.act`` (``utils.profiling``).
"""

import copy
from typing import Tuple

import torch

from oatomobile_torch.baselines.learned import bridge
from oatomobile_torch.baselines.learned.observation import (Observation,
                                                             observe)
from oatomobile_torch.models.dim import ImitativeModel
from oatomobile_torch.sim.types import SceneState, WorldParams
from oatomobile_torch.utils import profiling

ENCODER_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def encoder_copy(model: torch.nn.Module, encoder_dtype: str):
  """``model`` itself for ``"float32"``; for ``"bfloat16"`` a copy with
  every parameter (GroupNorm and merger included) in bfloat16, as the JAX
  package casts the whole parameter tree."""
  dtype = ENCODER_DTYPES[encoder_dtype]
  if dtype == torch.float32:
    return model
  return copy.deepcopy(model).to(dtype)


def encode(encoder: torch.nn.Module, context: dict) -> torch.Tensor:
  """z [B, 64] in float32 from the context, in the encoder's dtype (the
  context is cast to it; no autocast)."""
  dtype = next(encoder.parameters()).dtype
  ctx = {k: v.to(dtype) for k, v in context.items()}
  with torch.no_grad():
    return encoder.params_z(**ctx).to(torch.float32)


class DimPolicy:
  """``policy(world_params, states) -> (actions [B, 3], states)``.

  Freezes the model's parameters: the planner differentiates the plan
  only and leaves no ``.grad`` on the model.
  """

  def __init__(self,
               model: ImitativeModel,
               *,
               num_plan_steps: int = 20,
               lr: float = 5e-2,
               epsilon: float = 1.0,
               setpoint_frac: float = 0.5,
               use_brake: bool = True,
               curvature_slowdown: bool = True,
               warmup_floor: float = 20.0 / 3.6,
               speed_gain: float = 1.0,
               encoder_dtype: str = "float32") -> None:
    model.requires_grad_(False)
    model.eval()
    self.model = model
    self.encoder = encoder_copy(model, encoder_dtype)
    self._plan_kwargs = dict(num_steps=num_plan_steps, lr=lr,
                             epsilon=epsilon)
    self._bridge_kwargs = dict(setpoint_frac=setpoint_frac,
                               use_brake=use_brake,
                               curvature_slowdown=curvature_slowdown,
                               warmup_floor=warmup_floor,
                               speed_gain=speed_gain)

  def observe(self, world_params: WorldParams,
              states: SceneState) -> Observation:
    return observe(world_params, states, self.model.input_size)

  def encode(self, obs: Observation) -> torch.Tensor:
    return encode(self.encoder, obs.context)

  def plan(self, z: torch.Tensor, obs: Observation) -> torch.Tensor:
    """[B, T, 2] ego-frame plan."""
    return self.model.plan_from_z(z, goal=obs.goal, **self._plan_kwargs)

  def act(self, world_params: WorldParams, states: SceneState,
          plan: torch.Tensor,
          obs: Observation) -> Tuple[torch.Tensor, SceneState]:
    return bridge.plan_to_action(world_params, states, plan, goal=obs.goal,
                                 red_held=obs.red_held, bev=obs.lidar,
                                 **self._bridge_kwargs)

  def __call__(self, world_params: WorldParams,
               states: SceneState) -> Tuple[torch.Tensor, SceneState]:
    dev = states.hero_xy.device
    with profiling.span("dim.observe", dev):
      obs = self.observe(world_params, states)
    with profiling.span("dim.encode", dev):
      z = self.encode(obs)
    with profiling.span("dim.plan", dev):
      plan = self.plan(z, obs)
    with profiling.span("dim.act", dev):
      return self.act(world_params, states, plan, obs)


def make_dim_policy(model: ImitativeModel, **kwargs) -> DimPolicy:
  """The DIM policy of ``model`` (keyword arguments of ``DimPolicy``:
  ``num_plan_steps``, ``lr``, ``epsilon``, the bridge's ``setpoint_frac``,
  ``use_brake``, ``curvature_slowdown``, ``warmup_floor``, ``speed_gain``,
  and ``encoder_dtype`` "float32" or "bfloat16")."""
  return DimPolicy(model, **kwargs)
