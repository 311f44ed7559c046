"""The RIP ensemble's model FLOPs, counted from the frozen reference's
shapes (its modules on the ``meta`` device under
``torch.utils.flop_counter``: two operations a multiply-add of every
matrix product and convolution, forward and backward, nothing of the
elementwise work), as ``dim_flops`` counts the DIM's.  Never from the
program's code: a change to the program cannot move it.
"""

import functools

import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.counts import dim_flops
from perfbench.reference.policy import rip_policy


@functools.lru_cache(maxsize=None)
def _step_flops_per_scene(input_size, output_shape, members: int,
                          plan_steps: int, goals: int) -> int:
  config = {"input_size": input_size, "output_shape": output_shape}
  ensemble = [dim_flops._model(config) for _ in range(members)]  # pylint: disable=protected-access
  context = dim_flops._context(config, 1)  # pylint: disable=protected-access
  with FlopCounterMode(display=False) as counter:
    z = rip_policy.encode_members(ensemble, context)
    goal = torch.zeros(1, goals, 2, device="meta")
    rip_policy.plan(ensemble, z, goal, algorithm="WCM",
                    num_steps=plan_steps, lr=0.1, epsilon=1.0)
  return counter.get_total_flops()


def closed_loop_step_flops(config, scenes: int, goals: int = 10) -> int:
  """One closed-loop step of the RIP policy over ``scenes``: the K
  members' encoder and merger forwards, then ``num_plan_steps`` steps of
  one decode and the K members' priors with the goal likelihood, forward
  and backward, then the decode of the best iterate."""
  per_scene = _step_flops_per_scene(tuple(config["input_size"]),
                                    tuple(config["output_shape"]),
                                    int(config["members"]),
                                    int(config["num_plan_steps"]), goals)
  return per_scene * scenes
