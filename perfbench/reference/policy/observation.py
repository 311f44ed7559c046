"""What the learned in-loop policies observe each step: the BEV LIDAR, the
state sensors and the route goal, as the JAX package's DIM, RIP and CIL
policies each synthesise and prepare them."""

import dataclasses
from typing import Tuple

import torch

from perfbench.reference.models import transforms
from perfbench.reference import synth
from perfbench.reference.sim.types import SceneState, WorldParams

OBS_KEYS = ("lidar", "velocity", "is_at_traffic_light",
            "traffic_light_state", "goal")


@dataclasses.dataclass
class Observation:
  """One step's inputs of a learned policy, batched over scenes."""
  context: dict           # the models' context (NCHW visual features)
  goal: torch.Tensor      # [B, 10, 2] ego-frame route waypoints
  red_held: torch.Tensor  # [B] bool: at a red or yellow light
  lidar: torch.Tensor     # [B, 200, 200, 2] the raw BEV, for the bridge


def observe(world_params: WorldParams, states: SceneState,
            input_size: Tuple[int, int]) -> Observation:
  """Synthesises the policies' sensors (one BEV splat) and prepares the
  models' context at ``input_size``."""
  obs = synth.synthesize(world_params, states, OBS_KEYS)
  at_light = obs["is_at_traffic_light"]
  light = obs["traffic_light_state"]
  context = dict(
      visual_features=transforms.prepare_visual_features(obs["lidar"],
                                                         input_size),
      velocity=obs["velocity"],
      is_at_traffic_light=at_light[:, None].to(torch.float32),
      traffic_light_state=light[:, None].to(torch.float32),
  )
  return Observation(context=context, goal=obs["goal"][..., :2],
                     red_held=(at_light > 0.5) & (light < 1.5),
                     lidar=obs["lidar"])
