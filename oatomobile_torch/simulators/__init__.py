"""Simulator backends: the single-scene CUDA simulator."""

from oatomobile_torch.simulators.cuda.simulator import (CARLAAction,
                                                        CUDASimulator)

__all__ = ["CARLAAction", "CUDASimulator"]
