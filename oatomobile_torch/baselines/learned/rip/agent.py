"""Robust imitative planning over a K-model DIM ensemble: port of the JAX
package's ``baselines/learned/rip/agent.py`` (``stack_ensemble``,
``rip_plan`` and the single-scene ``RIPAgent``).

A shared latent plan is optimised under the K members' imitation
posteriors, aggregated per scene over K: WCM takes the min of the negated
posteriors, BCM the max and MA the mean (the JAX package keeps the
reference's naming).  The JAX package vmaps the K members over stacked
parameters; here the K members run in turn.
"""

import functools
from typing import Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

import oatomobile_torch
from oatomobile_torch.baselines.base import SetPointAgent
from oatomobile_torch.baselines.learned import common
from oatomobile_torch.baselines.learned.dim.policy import encode
from oatomobile_torch.models.dim import (CONTEXT_KEYS, ImitativeModel,
                                         best_adam_iterate, goal_likelihood)

ALGORITHMS = ("WCM", "MA", "BCM")


def stack_ensemble(models: Sequence[ImitativeModel]) -> nn.ModuleList:
  """The K members as one module list; they must share their shapes and
  device."""
  models = list(models)
  if not models:
    raise ValueError("an ensemble needs at least one model")
  first = models[0]
  for m in models[1:]:
    if (m.output_shape, m.input_size) != (first.output_shape,
                                          first.input_size):
      raise ValueError("ensemble members differ in output or input shape")
    if next(m.parameters()).device != next(first.parameters()).device:
      raise ValueError("ensemble members lie on different devices")
  return nn.ModuleList(models)


def rip_plan(ensemble: Sequence[ImitativeModel],
             goal: torch.Tensor,
             context: Mapping[str, torch.Tensor],
             *,
             algorithm: str = "WCM",
             num_steps: int = 10,
             lr=1e-1,
             epsilon=1.0,
             encoders: Optional[Sequence[nn.Module]] = None) -> torch.Tensor:
  """RIP plan [B, T, 2] for goals [B, K_goals, 2] and the models' context;
  ``lr`` and ``epsilon`` are numbers or 0-d tensors.

  ``encoders``: the members at the encoder's precision (from
  ``dim.policy.encoder_copy``); the members themselves when None.  z
  returns to float32 before the flow planner.
  """
  if algorithm not in ALGORITHMS:
    raise ValueError("algorithm {!r} is not one of {}".format(algorithm,
                                                             ALGORITHMS))
  encoders = ensemble if encoders is None else encoders
  zs = [encode(e, context) for e in encoders]  # K x [B, 64]
  first = ensemble[0]

  def loss_fn(x):
    """Per-scene aggregated negative posterior [B]."""
    y = first.decode(x, zs[0])
    gl = goal_likelihood(y, goal, epsilon=epsilon)
    neg = -torch.stack([m.imitation_prior_from_z(y, z) + gl
                        for m, z in zip(ensemble, zs)])  # [K, B]
    if algorithm == "WCM":
      return neg.amin(dim=0)
    if algorithm == "BCM":
      return neg.amax(dim=0)
    return neg.mean(dim=0)

  x0 = torch.zeros(zs[0].shape[:1] + first.output_shape, dtype=torch.float32,
                   device=zs[0].device)
  x_best = best_adam_iterate(loss_fn, x0, num_steps, lr)
  return first.decode(x_best, zs[0])


def rip_agent_plan(ensemble: nn.ModuleList, algorithm: str,
                   inputs: Mapping[str, torch.Tensor],
                   num_steps: int) -> torch.Tensor:
  """The RIP plan [1, T, 2] from a ``CapturedAct``'s inputs (the raw
  observation's model keys, ``lr`` and ``epsilon``)."""
  first = ensemble[0]
  sample = first.transform(inputs)
  context = common.model_context(sample, CONTEXT_KEYS)
  with torch.no_grad():
    return rip_plan(ensemble, sample.get("goal"), context,
                    algorithm=algorithm, num_steps=num_steps,
                    lr=inputs["lr"], epsilon=inputs["epsilon"])


class RIPAgent(SetPointAgent):
  """The robust imitative planning agent: one shared plan under the K
  members' aggregated posteriors, 10 Adam steps at lr 1e-1.  The plan
  runs as a ``common.CapturedAct`` (one captured step per ``num_steps``),
  as the JAX agent jits it."""

  def __init__(self, environment: oatomobile_torch.Env, *, algorithm: str,
               models: Sequence[ImitativeModel], **kwargs) -> None:
    """Args:
      algorithm: one of {"WCM", "MA", "BCM"}.
      models: the K ImitativeModels with their weights (the JAX agent takes
        one flax module and K parameter trees); frozen, on one device.
    """
    if algorithm not in ALGORITHMS:
      raise ValueError("algorithm {!r} is not one of {}".format(algorithm,
                                                               ALGORITHMS))
    super().__init__(environment=environment, **kwargs)
    self._ensemble = stack_ensemble(models)
    self._ensemble.requires_grad_(False)
    self._ensemble.eval()
    self._algorithm = algorithm
    self._plan = common.CapturedAct(
        functools.partial(rip_agent_plan, self._ensemble, algorithm),
        next(self._ensemble.parameters()).device)

  def __call__(self, observation: Mapping[str, np.ndarray],
               **kwargs) -> np.ndarray:
    obs = common.prepare_observation(observation)
    plan = self._plan(
        common.act_inputs(obs, lr=kwargs.get("lr", 1e-1),
                          epsilon=kwargs.get("epsilon", 1.0)),
        num_steps=kwargs.get("num_steps", 10))
    return common.interpolate_plan(plan)
