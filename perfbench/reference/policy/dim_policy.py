"""The DIM driving policy of the reference, a frozen copy of the
program's ``baselines/learned/dim/policy.py`` in float32: each step the
BEV (the plain splat), the MobileNetV2 context encoder, ``num_plan_steps``
Adam steps of the flow planner, and the plan -> control bridge."""

from typing import Tuple

import torch

from perfbench.reference.policy import bridge
from perfbench.reference.policy.observation import Observation, observe
from perfbench.reference.models.dim import ImitativeModel
from perfbench.reference.sim.types import SceneState, WorldParams


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
               speed_gain: float = 1.0) -> None:
    model.requires_grad_(False)
    model.eval()
    self.model = model
    self.encoder = model
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
    obs = self.observe(world_params, states)
    plan = self.plan(self.encode(obs), obs)
    return self.act(world_params, states, plan, obs)
