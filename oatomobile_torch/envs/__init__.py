"""Environments: the batched scene environment."""

from oatomobile_torch.envs.batched import BatchedEnv

__all__ = ["BatchedEnv"]
