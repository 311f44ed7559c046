"""Learned agents (DIM, RIP, CIL): the single-scene agents, the in-loop
policies for batched rollouts and their plan -> control bridge; the port
of the JAX package's ``baselines/learned``."""

from oatomobile_torch.baselines.learned.cil.agent import CILAgent
from oatomobile_torch.baselines.learned.dim.agent import DIMAgent
from oatomobile_torch.baselines.learned.rip.agent import RIPAgent

__all__ = ["CILAgent", "DIMAgent", "RIPAgent"]
