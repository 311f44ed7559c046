"""World model over a scene batch: the port of the JAX package's sim/."""

from oatomobile_torch.sim.types import (PIDState, SceneState, VehicleSpec,
                                        WorldParams)
from oatomobile_torch.sim.world import (init_scene, init_scene_batch,
                                        make_params, rollout, world_step)
from oatomobile_torch.sim.autopilot import autopilot_policy

__all__ = [
    "PIDState",
    "SceneState",
    "VehicleSpec",
    "WorldParams",
    "world_step",
    "init_scene",
    "init_scene_batch",
    "make_params",
    "rollout",
    "autopilot_policy",
]
