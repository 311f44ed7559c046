"""The single-scene simulator backend on a CUDA device (the reference's
CARLA API surface), the counterpart of the JAX package's
``simulators/tpu``."""

from oatomobile_torch.simulators.cuda import defaults
from oatomobile_torch.simulators.cuda.simulator import (CARLAAction,
                                                        CUDASimulator)

__all__ = ["CARLAAction", "CUDASimulator", "defaults"]
