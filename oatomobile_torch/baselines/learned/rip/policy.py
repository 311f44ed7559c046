"""The RIP driving policy for batched rollouts: port of the JAX package's
``baselines/learned/rip/policy.py``: BEV synthesis, the K members'
WCM/MA/BCM-aggregated planning, the plan -> control bridge.

Each step: BEV synthesis (one splat kernel launch), the K members'
MobileNetV2 context encoders in turn, ``num_plan_steps`` Adam steps of the
shared plan under the K flow priors, and the bridge.  The policy is a
``BatchedEnv.rollout`` policy; its four stages are methods, and a call
marks each on the device clock as the span ``rip.observe``,
``rip.encode`` (count K: the members encoded), ``rip.plan`` (count K x
``num_plan_steps``: the member priors evaluated) or ``rip.act``
(``utils.profiling``).
"""

from typing import Sequence, Tuple

import torch

from oatomobile_torch.baselines.learned import bridge
from oatomobile_torch.baselines.learned.dim.policy import encoder_copy
from oatomobile_torch.baselines.learned.observation import (Observation,
                                                             observe)
from oatomobile_torch.baselines.learned.rip.agent import (rip_encode,
                                                          rip_plan_from_z,
                                                          stack_ensemble)
from oatomobile_torch.models.dim import ImitativeModel
from oatomobile_torch.sim.types import SceneState, WorldParams
from oatomobile_torch.utils import profiling


class RipPolicy:
  """``policy(world_params, states) -> (actions [B, 3], states)`` over the
  ensemble ``models``.

  Freezes the members' parameters: the planner differentiates the plan
  only and leaves no ``.grad`` on the members.
  """

  def __init__(self,
               models: Sequence[ImitativeModel],
               *,
               algorithm: str = "WCM",
               num_plan_steps: int = 10,
               lr: float = 1e-1,
               epsilon: float = 1.0,
               setpoint_frac: float = 0.5,
               use_brake: bool = True,
               curvature_slowdown: bool = True,
               warmup_floor: float = 20.0 / 3.6,
               speed_gain: float = 1.0,
               encoder_dtype: str = "float32") -> None:
    self.ensemble = stack_ensemble(models)
    self.ensemble.requires_grad_(False)
    self.ensemble.eval()
    self.encoders = [encoder_copy(m, encoder_dtype) for m in self.ensemble]
    self.num_plan_steps = num_plan_steps
    self._plan_kwargs = dict(algorithm=algorithm, num_steps=num_plan_steps,
                             lr=lr, epsilon=epsilon)
    self._bridge_kwargs = dict(setpoint_frac=setpoint_frac,
                               use_brake=use_brake,
                               curvature_slowdown=curvature_slowdown,
                               warmup_floor=warmup_floor,
                               speed_gain=speed_gain)

  def observe(self, world_params: WorldParams,
              states: SceneState) -> Observation:
    return observe(world_params, states, self.ensemble[0].input_size)

  def encode(self, obs: Observation) -> torch.Tensor:
    """z [K, B, 64] in float32."""
    return rip_encode(self.encoders, obs.context)

  def plan(self, z: torch.Tensor, obs: Observation) -> torch.Tensor:
    """[B, T, 2] ego-frame plan."""
    return rip_plan_from_z(self.ensemble, z, obs.goal, **self._plan_kwargs)

  def act(self, world_params: WorldParams, states: SceneState,
          plan: torch.Tensor,
          obs: Observation) -> Tuple[torch.Tensor, SceneState]:
    return bridge.plan_to_action(world_params, states, plan, goal=obs.goal,
                                 red_held=obs.red_held, bev=obs.lidar,
                                 **self._bridge_kwargs)

  def __call__(self, world_params: WorldParams,
               states: SceneState) -> Tuple[torch.Tensor, SceneState]:
    dev = states.hero_xy.device
    members = len(self.ensemble)
    with profiling.span("rip.observe", dev):
      obs = self.observe(world_params, states)
    with profiling.span("rip.encode", dev, count=members):
      z = self.encode(obs)
    with profiling.span("rip.plan", dev,
                        count=members * self.num_plan_steps):
      plan = self.plan(z, obs)
    with profiling.span("rip.act", dev):
      return self.act(world_params, states, plan, obs)


def make_rip_policy(models: Sequence[ImitativeModel],
                    *,
                    algorithm: str = "WCM",
                    num_plan_steps: int = 10,
                    lr: float = 1e-1,
                    epsilon: float = 1.0,
                    setpoint_frac: float = 0.5,
                    use_brake: bool = True,
                    curvature_slowdown: bool = True,
                    warmup_floor: float = 20.0 / 3.6,
                    speed_gain: float = 1.0,
                    encoder_dtype: str = "float32") -> RipPolicy:
  """The RIP policy over the ensemble ``models`` (their parameters are
  frozen)."""
  return RipPolicy(models, algorithm=algorithm,
                   num_plan_steps=num_plan_steps, lr=lr, epsilon=epsilon,
                   setpoint_frac=setpoint_frac, use_brake=use_brake,
                   curvature_slowdown=curvature_slowdown,
                   warmup_floor=warmup_floor, speed_gain=speed_gain,
                   encoder_dtype=encoder_dtype)
