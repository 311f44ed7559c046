"""The RIP driving policy of the reference: robust imitative planning
(Filos et al., arXiv:2006.14911) over K Deep Imitative Models, in plain
PyTorch and IEEE float32 (the caller, ``ReferenceEnv.rollout``, turns
TF32 off for matrix products and convolutions).

Each step: the BEV (the plain splat), the K members' context encoders in
turn, ``num_plan_steps`` Adam steps of one shared plan, and the plan ->
control bridge.  The plan's loss for each scene is the K members'
negated log posteriors (the imitation prior of the plan decoded through
member 0, plus the goal likelihood), aggregated over the members: WCM
takes the minimum, BCM the maximum, MA the mean.  Adam runs in optax's
order (the reference's ``best_adam_iterate``), and the plan returned is
the strict best iterate decoded through member 0.

Departures from OATomobile's ``baselines/torch/rip/agent.py``:
  - GroupNorm with groups of 8 channels in place of BatchNorm in each
    member's encoder, as in the ``dim`` configuration;
  - the members' weights are drawn from the run's seed (no trained
    checkpoints exist).
"""

from typing import Mapping, Sequence, Tuple

import torch

from perfbench.reference.models.dim import (ImitativeModel,
                                            best_adam_iterate,
                                            goal_likelihood)
from perfbench.reference.policy import bridge
from perfbench.reference.policy.dim_policy import encode
from perfbench.reference.policy.observation import Observation, observe
from perfbench.reference.sim.types import SceneState, WorldParams

ALGORITHMS = ("WCM", "MA", "BCM")


def encode_members(members: Sequence[ImitativeModel],
                   context: Mapping[str, torch.Tensor]) -> torch.Tensor:
  """z [K, B, 64]: each member's context encoding, in turn."""
  return torch.stack([encode(m, context) for m in members])


def aggregate(neg: torch.Tensor, algorithm: str) -> torch.Tensor:
  """The per-scene loss [B] of the members' negated posteriors [K, B]."""
  if algorithm == "WCM":
    return neg.amin(dim=0)
  if algorithm == "BCM":
    return neg.amax(dim=0)
  if algorithm == "MA":
    return neg.mean(dim=0)
  raise ValueError("algorithm {!r}: one of {}".format(algorithm, ALGORITHMS))


def plan_loss(members: Sequence[ImitativeModel], z: torch.Tensor,
              goal: torch.Tensor, x: torch.Tensor, algorithm: str,
              epsilon) -> torch.Tensor:
  """The aggregated negative posterior [B] of the plan ``x``."""
  y = members[0].decode(x, z[0])
  gl = goal_likelihood(y, goal, epsilon=epsilon)
  neg = -torch.stack([m.imitation_prior_from_z(y, z[k]) + gl
                      for k, m in enumerate(members)])
  return aggregate(neg, algorithm)


def plan(members: Sequence[ImitativeModel], z: torch.Tensor,
         goal: torch.Tensor, *, algorithm: str, num_steps: int, lr,
         epsilon) -> torch.Tensor:
  """The plan [B, T, 2]: ``num_steps`` Adam steps from zeros
  (``best_adam_iterate``, written out in optax's order), each from the
  gradient of the summed per-scene loss; per scene the iterate of the
  lowest loss (strictly lower than every earlier one), decoded."""
  first = members[0]
  x0 = torch.zeros(z.shape[1:2] + first.output_shape, dtype=torch.float32,
                   device=z.device)
  x_best = best_adam_iterate(
      lambda x: plan_loss(members, z, goal, x, algorithm, epsilon), x0,
      num_steps, lr)
  return first.decode(x_best, z[0])


class RipPolicy:
  """``policy(world_params, states) -> (actions [B, 3], states)`` over
  the members (their parameters frozen)."""

  def __init__(self,
               members: Sequence[ImitativeModel],
               *,
               algorithm: str = "WCM",
               num_plan_steps: int = 10,
               lr: float = 1e-1,
               epsilon: float = 1.0,
               setpoint_frac: float = 0.5,
               use_brake: bool = True,
               curvature_slowdown: bool = True,
               warmup_floor: float = 20.0 / 3.6,
               speed_gain: float = 1.0) -> None:
    if algorithm not in ALGORITHMS:
      raise ValueError("algorithm {!r}: one of {}".format(algorithm,
                                                         ALGORITHMS))
    self.members = list(members)
    for m in self.members:
      m.requires_grad_(False)
      m.eval()
    self._plan_kwargs = dict(algorithm=algorithm, num_steps=num_plan_steps,
                             lr=lr, epsilon=epsilon)
    self._bridge_kwargs = dict(setpoint_frac=setpoint_frac,
                               use_brake=use_brake,
                               curvature_slowdown=curvature_slowdown,
                               warmup_floor=warmup_floor,
                               speed_gain=speed_gain)

  def observe(self, world_params: WorldParams,
              states: SceneState) -> Observation:
    return observe(world_params, states, self.members[0].input_size)

  def encode(self, obs: Observation) -> torch.Tensor:
    return encode_members(self.members, obs.context)

  def plan(self, z: torch.Tensor, obs: Observation) -> torch.Tensor:
    return plan(self.members, z, obs.goal, **self._plan_kwargs)

  def act(self, world_params: WorldParams, states: SceneState,
          plan_: torch.Tensor,
          obs: Observation) -> Tuple[torch.Tensor, SceneState]:
    return bridge.plan_to_action(world_params, states, plan_, goal=obs.goal,
                                 red_held=obs.red_held, bev=obs.lidar,
                                 **self._bridge_kwargs)

  def __call__(self, world_params: WorldParams,
               states: SceneState) -> Tuple[torch.Tensor, SceneState]:
    obs = self.observe(world_params, states)
    return self.act(world_params, states, self.plan(self.encode(obs), obs),
                    obs)
