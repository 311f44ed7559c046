"""The CIL driving policy for batched rollouts: port of the JAX package's
``baselines/learned/cil/policy.py``: BEV synthesis, the command from the
goal's geometry, the BehaviouralModel's plan, the plan -> control
bridge."""

from typing import Tuple

import torch

from oatomobile_torch.baselines.learned import bridge
from oatomobile_torch.baselines.learned.observation import observe
from oatomobile_torch.models.cil import BehaviouralModel
from oatomobile_torch.sim.types import SceneState, WorldParams
from oatomobile_torch.sim.util import norm


def mode_from_goal(goal: torch.Tensor) -> torch.Tensor:
  """[B] command labels {0 FORWARD, 1 STOP, 2 LEFT, 3 RIGHT} from the
  goal endpoints of [B, K, 2] (the JAX package's ``mode_from_goal_jnp``:
  a signed angle, +y to the right)."""
  end = goal[:, -1]
  theta = torch.rad2deg(torch.atan2(end[:, 1], end[:, 0]))
  mode = torch.where(theta > 15.0, 3.0, torch.where(theta < -15.0, 2.0, 0.0))
  return torch.where(norm(end) < 3.0, 1.0, mode)


def make_cil_policy(model: BehaviouralModel,
                    *,
                    setpoint_frac: float = 0.5,
                    use_brake: bool = True,
                    curvature_slowdown: bool = True,
                    warmup_floor: float = 20.0 / 3.6,
                    speed_gain: float = 1.0):
  """Returns ``policy(world_params, states) -> (actions [B, 3], states)``
  (the model's parameters are frozen)."""
  model.requires_grad_(False)
  model.eval()

  def policy(world_params: WorldParams,
             states: SceneState) -> Tuple[torch.Tensor, SceneState]:
    obs = observe(world_params, states, model.input_size)
    mode = mode_from_goal(obs.goal)
    plan40 = model(mode=mode[:, None], **obs.context)  # [B, 40, 2] @ 0.1 s
    # Points at 1, 2, 3, 4 s: the bridge's 1 s spacing, as DIM's.
    plan = plan40[:, 9::10]
    return bridge.plan_to_action(
        world_params, states, plan, setpoint_frac=setpoint_frac,
        use_brake=use_brake, curvature_slowdown=curvature_slowdown,
        warmup_floor=warmup_floor, goal=obs.goal, speed_gain=speed_gain,
        red_held=obs.red_held, bev=obs.lidar)

  return policy
