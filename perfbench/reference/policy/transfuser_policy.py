"""The TransFuser driving policy of the reference, in plain PyTorch and
IEEE float32 (the caller, ``ReferenceEnv.rollout``, turns TF32 off for
matrix products and convolutions).

Each step: the front camera (``reference/cameras.py``) and the BEV (the
plain splat); the camera's centre 180 x 180 square and the 200 x 200 BEV
resized bilinearly to 256 x 256; the ego speed (the norm of the
velocity) and the target point (the last of the 10 ego-frame goal
waypoints); TransFuser (``reference/models/transfuser.py``); the plan ->
control bridge with its defaults.

Departures from the source (github.com/autonomousvision/transfuser,
branch ``cvpr2021``):
  - the camera is the port's analytic 180 x 320, 90 degree camera with a
    palette, centre-cropped and resized, in place of CARLA's 400 x 300,
    100 degree photoreal camera centre-cropped to 256 x 256 with no
    resize;
  - the LiDAR is the port's 200 x 200 x 2 OATomobile BEV, resized, in
    place of the source's 8 pixels a metre histogram;
  - the control is the port's bridge (OATomobile's PID controllers) in
    place of the source's two PID controllers;
  - the target point is the route's last goal waypoint;
  - the weights are drawn from the run's seed (no trained checkpoint).
"""

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from perfbench.reference import cameras, synth
from perfbench.reference.models.transfuser import (TransFuser,
                                                   normalize_imagenet)
from perfbench.reference.policy import bridge
from perfbench.reference.sim.types import SceneState, WorldParams
from perfbench.reference.sim.util import norm

INPUT_SIZE = 256
KEYS = ("lidar", "velocity", "goal", "is_at_traffic_light",
        "traffic_light_state")


@dataclasses.dataclass
class Observation:
  image: torch.Tensor         # [B, 3, 256, 256], ImageNet-normalised
  lidar: torch.Tensor         # [B, 2, 256, 256]
  speed: torch.Tensor         # [B]
  target_point: torch.Tensor  # [B, 2]
  goal: torch.Tensor          # [B, 10, 2]
  red_held: torch.Tensor      # [B]
  bev: torch.Tensor           # [B, 200, 200, 2]


def _to_input(nhwc: torch.Tensor) -> torch.Tensor:
  nchw = nhwc.permute(0, 3, 1, 2).contiguous()
  return F.interpolate(nchw, size=(INPUT_SIZE, INPUT_SIZE), mode="bilinear",
                       align_corners=False)


def observe(world_params: WorldParams, states: SceneState) -> Observation:
  rgb = cameras.camera_rgb(world_params, states, 0.0)    # [B, 180, 320, 3]
  obs = synth.synthesize(world_params, states, KEYS)
  h, w = rgb.shape[1:3]
  square = rgb[:, :, (w - h) // 2:(w - h) // 2 + h]
  at_light = obs["is_at_traffic_light"]
  light = obs["traffic_light_state"]
  goal = obs["goal"][..., :2]
  return Observation(image=normalize_imagenet(_to_input(square)),
                     lidar=_to_input(obs["lidar"]),
                     speed=norm(obs["velocity"]),
                     target_point=goal[:, -1],
                     goal=goal,
                     red_held=(at_light > 0.5) & (light < 1.5),
                     bev=obs["lidar"])


class TransFuserPolicy:
  """``policy(world_params, states) -> (actions [B, 3], states)`` (the
  model's parameters frozen, BatchNorm on its running statistics).
  Building it turns TF32 off; ``ReferenceEnv.rollout`` turns it on for
  its calls in the ``"tf32"`` precision only."""

  def __init__(self, model: TransFuser) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model.requires_grad_(False)
    model.eval()
    self.model = model

  def plan(self, obs: Observation) -> torch.Tensor:
    with torch.no_grad():
      return self.model(obs.image, obs.lidar, obs.speed, obs.target_point)

  def __call__(self, world_params: WorldParams,
               states: SceneState) -> Tuple[torch.Tensor, SceneState]:
    obs = observe(world_params, states)
    return bridge.plan_to_action(world_params, states, self.plan(obs),
                                 goal=obs.goal, red_held=obs.red_held,
                                 bev=obs.bev)
