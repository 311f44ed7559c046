"""Observation ops: coordinate transforms and the BEV LIDAR splat (plain
and CUDA)."""

from oatomobile_torch.ops import bev, bev_cuda, transforms

__all__ = ["bev", "bev_cuda", "transforms"]
