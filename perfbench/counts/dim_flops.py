"""The DIM's model FLOPs, counted from the frozen reference's shapes (its
modules on the ``meta`` device under ``torch.utils.flop_counter``: two
operations a multiply-add of every matrix product and convolution,
forward and backward, nothing of the elementwise work).  Never from the
program's code: a change to the program cannot move it.
"""

import functools

import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.reference.models.dim import ImitativeModel


def _model(config) -> ImitativeModel:
  return ImitativeModel(tuple(config["output_shape"]),
                        tuple(config["input_size"]), device="meta")


def _context(config, batch: int) -> dict:
  h, w = config["input_size"]
  return dict(
      visual_features=torch.zeros(batch, 2, h, w, device="meta"),
      velocity=torch.zeros(batch, 3, device="meta"),
      is_at_traffic_light=torch.zeros(batch, 1, device="meta"),
      traffic_light_state=torch.zeros(batch, 1, device="meta"))


@functools.lru_cache(maxsize=None)
def _step_flops_per_scene(input_size, output_shape, plan_steps: int,
                          goals: int) -> int:
  config = {"input_size": input_size, "output_shape": output_shape}
  model = _model(config)
  with FlopCounterMode(display=False) as counter:
    z = model.params_z(**_context(config, 1))
    goal = torch.zeros(1, goals, 2, device="meta")
    model.plan_from_z(z, num_steps=plan_steps, goal=goal, lr=0.05,
                      epsilon=1.0)
  return counter.get_total_flops()


def closed_loop_step_flops(config, scenes: int, goals: int = 10) -> int:
  """One closed-loop step of the DIM policy over ``scenes``: the encoder
  and merger forward, and ``num_plan_steps`` forward and backward passes
  of the flow with the goal likelihood, then the decode of the best
  iterate."""
  per_scene = _step_flops_per_scene(tuple(config["input_size"]),
                                    tuple(config["output_shape"]),
                                    int(config["num_plan_steps"]), goals)
  return per_scene * scenes


@functools.lru_cache(maxsize=None)
def _update_flops_per_sample(input_size, output_shape, image: int) -> int:
  from perfbench.reference import threefry  # pylint: disable=import-outside-toplevel
  from perfbench.reference import train as ref_train  # pylint: disable=import-outside-toplevel
  config = {"input_size": input_size, "output_shape": output_shape}
  model = _model(config)
  batch = {
      "lidar": torch.zeros(1, image, image, 2, device="meta"),
      "velocity": torch.zeros(1, 3, device="meta"),
      "is_at_traffic_light": torch.zeros(1, 1, device="meta"),
      "traffic_light_state": torch.zeros(1, 1, device="meta"),
      "player_future": torch.zeros(1, 80, 3, device="meta"),
  }
  with FlopCounterMode(display=False) as counter:
    ref_train.nll(model, batch, threefry.PRNGKey(0, "meta"), 0.25)
  return 3 * counter.get_total_flops()


def training_update_flops(config, batch: int, image: int = 200) -> int:
  """One update of the DIM trainer at ``batch``: the NLL's forward (the
  encoder and merger, the flow's inverse) and its backward, counted as
  twice the forward (a product's gradients with respect to its two
  operands), the usual model-FLOPs rule.  The counter's own formula for
  the backward of a grouped convolution ignores the groups and would
  count MobileNetV2's depthwise layers twentyfold."""
  return batch * _update_flops_per_sample(
      tuple(config["input_size"]), tuple(config["output_shape"]), image)
