"""The TransFuser driving policy for batched rollouts: the front camera and
the BEV LiDAR through ``models/transfuser.TransFuser``, then the plan ->
control bridge.

Each step: one ``synth.synthesize`` call (one camera ray cast, one splat
kernel launch), the camera's centre square and the BEV resized to the
model's input, both trunks with their four fusions, the GRU's waypoints,
and the bridge with its own defaults.  The policy is a
``BatchedEnv.rollout`` policy; its stages are methods, and a call marks
each on the device clock as the span ``transfuser.observe``,
``transfuser.encode`` (``count``: the 4 fusion stages; inside it the
model's ``transfuser.trunk`` and ``transfuser.fuse`` marks),
``transfuser.decode`` (``count``: the waypoints) or ``transfuser.act``
(``utils.profiling``).
"""

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from oatomobile_torch.baselines.learned import bridge
from oatomobile_torch.models.resnet import STAGE_CHANNELS
from oatomobile_torch.models.transfuser import (INPUT_SIZE, PRED_LEN,
                                                TransFuser,
                                                normalize_imagenet)
from oatomobile_torch.sensors import synth
from oatomobile_torch.sim.types import SceneState, WorldParams
from oatomobile_torch.sim.util import norm
from oatomobile_torch.utils import profiling

OBS_KEYS = ("front_camera_rgb", "lidar", "velocity", "goal",
            "is_at_traffic_light", "traffic_light_state")


@dataclasses.dataclass
class TransFuserObservation:
  """One step's inputs of the policy, batched over scenes."""
  image: torch.Tensor         # [B, 3, 256, 256] ImageNet-normalised camera
  lidar: torch.Tensor         # [B, 2, 256, 256] the BEV, resized
  speed: torch.Tensor         # [B] m/s
  target_point: torch.Tensor  # [B, 2] the last ego-frame goal waypoint
  goal: torch.Tensor          # [B, 10, 2] ego-frame route waypoints
  red_held: torch.Tensor      # [B] bool: at a red or yellow light
  bev: torch.Tensor           # [B, 200, 200, 2] the raw BEV, for the bridge


def resize(nhwc: torch.Tensor) -> torch.Tensor:
  """NHWC images to NCHW at the model's input size: bilinear, half-pixel
  centres, no antialiasing."""
  nchw = nhwc.permute(0, 3, 1, 2).contiguous()
  return F.interpolate(nchw, size=(INPUT_SIZE, INPUT_SIZE), mode="bilinear",
                       align_corners=False)


def prepare_image(rgb: torch.Tensor) -> torch.Tensor:
  """[B, H, W, 3] camera (H <= W) -> its centre H x H square, resized to
  the model's input and ImageNet-normalised."""
  h, w = rgb.shape[1:3]
  left = (w - h) // 2
  return normalize_imagenet(resize(rgb[:, :, left:left + h]))


def observe(world_params: WorldParams,
            states: SceneState) -> TransFuserObservation:
  """Synthesises the policy's sensors (one camera ray cast, one BEV
  splat) and prepares the model's inputs."""
  obs = synth.synthesize(world_params, states, OBS_KEYS)
  at_light = obs["is_at_traffic_light"]
  light = obs["traffic_light_state"]
  goal = obs["goal"][..., :2]
  return TransFuserObservation(
      image=prepare_image(obs["front_camera_rgb"]),
      lidar=resize(obs["lidar"]),
      speed=norm(obs["velocity"]),
      target_point=goal[:, -1],
      goal=goal,
      red_held=(at_light > 0.5) & (light < 1.5),
      bev=obs["lidar"])


class TransFuserPolicy:
  """``policy(world_params, states) -> (actions [B, 3], states)``.

  Freezes the model and puts it in eval mode (BatchNorm with its running
  statistics)."""

  def __init__(self, model: TransFuser) -> None:
    model.requires_grad_(False)
    model.eval()
    self.model = model

  def observe(self, world_params: WorldParams,
              states: SceneState) -> TransFuserObservation:
    return observe(world_params, states)

  def encode(self, obs: TransFuserObservation) -> torch.Tensor:
    """[B, 512] fused features."""
    with torch.no_grad():
      return self.model.encode(obs.image, obs.lidar, obs.speed)

  def decode(self, features: torch.Tensor,
             obs: TransFuserObservation) -> torch.Tensor:
    """[B, PRED_LEN, 2] ego-frame plan."""
    with torch.no_grad():
      return self.model.decode(features, obs.target_point)

  def act(self, world_params: WorldParams, states: SceneState,
          plan: torch.Tensor,
          obs: TransFuserObservation) -> Tuple[torch.Tensor, SceneState]:
    return bridge.plan_to_action(world_params, states, plan, goal=obs.goal,
                                 red_held=obs.red_held, bev=obs.bev)

  def __call__(self, world_params: WorldParams,
               states: SceneState) -> Tuple[torch.Tensor, SceneState]:
    dev = states.hero_xy.device
    with profiling.span("transfuser.observe", dev):
      obs = self.observe(world_params, states)
    with profiling.span("transfuser.encode", dev, count=len(STAGE_CHANNELS)):
      features = self.encode(obs)
    with profiling.span("transfuser.decode", dev, count=PRED_LEN):
      plan = self.decode(features, obs)
    with profiling.span("transfuser.act", dev):
      return self.act(world_params, states, plan, obs)


def make_transfuser_policy(model: TransFuser) -> TransFuserPolicy:
  """The TransFuser policy over ``model`` (its parameters are frozen)."""
  return TransFuserPolicy(model)
