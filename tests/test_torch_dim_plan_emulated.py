"""The DIM planner's CUDA source, built by g++ for the CPU and run with
each CUDA thread a host thread (``tests/cuda_emulation/cuda_runtime.h``),
against the plain version (``ops/dim_plan_cuda.plan_reference``).

The kernel cannot run here; this holds its indexing, its barriers and
shuffles, its ragged last tile and the wrapper's packing of its arguments
(``dim_plan_cuda.launch``) on the CPU.  The two sum in different orders
and the host's libm stands in for CUDA's, so plans agree to float32
rounding (1e-5 m) and choose the same best iterate.  Skips without g++.
"""

import pytest
import torch

from oatomobile_torch.models import ImitativeModel
from oatomobile_torch.ops import dim_plan_cuda
from torch_port_helpers import emulated_library

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
  """The kernel's library built from ``csrc/dim_plan.cu`` for the host."""
  return emulated_library(
      dim_plan_cuda.KERNEL, tmp_path_factory.mktemp("dim_plan_emulated"),
      launches=1,
      prelude="namespace { alignas(16) float4 smem4[1 << 16]; }\n"
      "std::size_t emulated_smem_bytes() { return sizeof(smem4); }\n")


def model_of(horizon: int) -> ImitativeModel:
  model = ImitativeModel((horizon, 2), (32, 32),
                         generator=torch.Generator().manual_seed(7),
                         device="cpu")
  return model.requires_grad_(False)


@pytest.mark.parametrize("batch,horizon,num_steps,goal,tensors", [
    (1, 4, 20, True, False),     # the single-scene agent
    (9, 4, 5, True, True),       # a ragged second tile; 0-d lr, epsilon
    (8, 4, 20, False, False),    # no goal
    (3, 8, 3, True, False),      # the longest horizon
    (2, 1, 4, True, False),      # the shortest
    (5, 4, 0, True, False),      # no steps: decode(0, z)
])
def test_emulated_kernel_matches_plain_version(emulated, batch, horizon,
                                               num_steps, goal, tensors):
  model = model_of(horizon)
  weights = dim_plan_cuda.flow_weights(model.decoder)
  g = torch.Generator().manual_seed(batch * 10 + horizon)
  z = torch.randn(batch, 64, generator=g) * 0.5
  goals = ((torch.randn(batch, 10, 3, generator=g) * 4)[..., :2]
           if goal else None)
  lr, epsilon = ((torch.tensor(0.05), torch.tensor(0.8)) if tensors
                 else (0.05, 0.8))
  kwargs = dict(num_steps=num_steps, lr=lr, epsilon=epsilon,
                horizon=horizon)
  out, best = dim_plan_cuda.launch(emulated, weights, z, goals, stream=None,
                                   **kwargs)
  want, want_best = dim_plan_cuda.plan_reference(weights, z, goals, **kwargs)
  assert torch.equal(best, want_best)
  assert (out - want).abs().max().item() <= 1e-5


def test_emulated_entry_point_refuses_what_the_kernel_does_not_take(
    emulated):
  weights = dim_plan_cuda.flow_weights(model_of(4).decoder)
  z = torch.zeros(2, 64)
  for kwargs, goal in ((dict(horizon=9), None),
                       (dict(num_steps=257), None),
                       ({}, torch.zeros(2, 33, 2))):
    args = dict(dict(num_steps=2, lr=0.05, epsilon=1.0, horizon=4), **kwargs)
    with pytest.raises(RuntimeError):
      dim_plan_cuda.launch(emulated, weights, z, goal, stream=None, **args)
