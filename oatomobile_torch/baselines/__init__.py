"""Baseline agents: rule-based and learned."""

from oatomobile_torch.baselines.base import SetPointAgent

__all__ = ["SetPointAgent"]
