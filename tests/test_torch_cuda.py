"""The CUDA kernels of oatomobile_torch against their plain versions, on
the card.  Marked ``cuda``: skipped where no CUDA device and nvcc exist
(run them on a card with
``python -m pytest --noconftest tests/test_torch_cuda.py``: the tests'
conftest sets up JAX, which a card's machine need not have)."""

import os
import shutil

import pytest
import torch

from oatomobile_torch.envs.batched import BatchedEnv
from oatomobile_torch.ops import bev, bev_cuda

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device")
  if not (shutil.which("nvcc") or
          os.path.exists("/usr/local/cuda/bin/nvcc")):
    pytest.skip("needs nvcc to build the kernels")
  return torch.device("cuda")


@pytest.mark.parametrize("town,vehicles,pedestrians",
                         [("Town01", 16, 0), ("Town03", 24, 16)])
def test_bev_splat_kernel_matches_plain_version(card, town, vehicles,
                                                pedestrians):
  env = BatchedEnv(town, 16, num_vehicles=vehicles,
                   num_pedestrians=pedestrians, seed=1, device=card)
  env.rollout(10, compute=())
  inputs = bev.gather_inputs(env.params, env.state)
  before = bev_cuda.launches
  out = bev_cuda.splat_lidar_batch(*inputs)
  assert bev_cuda.launches == before + 1
  ref = bev_cuda.splat_lidar_batch_reference(*inputs)
  torch.cuda.synchronize()
  # Same float32 roundings (no FMA in the kernel): expected equal; at most
  # 1e-4 of pixels may sit within rounding of a rect edge.
  assert float((out != ref).float().mean()) < 1e-4
