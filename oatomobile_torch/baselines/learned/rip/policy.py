"""The RIP driving policy for batched rollouts: port of the JAX package's
``baselines/learned/rip/policy.py``: BEV synthesis, the K members'
WCM/MA/BCM-aggregated planning, the plan -> control bridge."""

from typing import Sequence, Tuple

import torch

from oatomobile_torch.baselines.learned import bridge
from oatomobile_torch.baselines.learned.dim.policy import encoder_copy
from oatomobile_torch.baselines.learned.observation import observe
from oatomobile_torch.baselines.learned.rip.agent import (rip_plan,
                                                          stack_ensemble)
from oatomobile_torch.models.dim import ImitativeModel
from oatomobile_torch.sim.types import SceneState, WorldParams


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
                    encoder_dtype: str = "float32"):
  """Returns ``policy(world_params, states) -> (actions [B, 3], states)``
  over the ensemble ``models`` (their parameters are frozen)."""
  ensemble = stack_ensemble(models)
  ensemble.requires_grad_(False)
  ensemble.eval()
  encoders = [encoder_copy(m, encoder_dtype) for m in ensemble]
  input_size = ensemble[0].input_size

  def policy(world_params: WorldParams,
             states: SceneState) -> Tuple[torch.Tensor, SceneState]:
    obs = observe(world_params, states, input_size)
    plan = rip_plan(ensemble, obs.goal, obs.context, algorithm=algorithm,
                    num_steps=num_plan_steps, lr=lr, epsilon=epsilon,
                    encoders=encoders)
    return bridge.plan_to_action(
        world_params, states, plan, setpoint_frac=setpoint_frac,
        use_brake=use_brake, curvature_slowdown=curvature_slowdown,
        warmup_floor=warmup_floor, goal=obs.goal, speed_gain=speed_gain,
        red_held=obs.red_held, bev=obs.lidar)

  return policy
