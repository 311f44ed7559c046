"""Environments: the batched scene environment and the single-scene gym
environments of the reference's API."""

from oatomobile_torch.envs.batched import BatchedEnv
from oatomobile_torch.envs.carla import (CARLAEnv, CARLANavEnv,
                                         CollisionsMetric, DistanceMetric,
                                         LaneInvasionsMetric,
                                         TerminateOnCollisionWrapper,
                                         TerminateOnLaneInvasionWrapper)

__all__ = [
    "BatchedEnv",
    "CARLAEnv",
    "CARLANavEnv",
    "CollisionsMetric",
    "DistanceMetric",
    "LaneInvasionsMetric",
    "TerminateOnCollisionWrapper",
    "TerminateOnLaneInvasionWrapper",
]
