"""Package rules of oatomobile_torch: no JAX anywhere, the card by
default, and a kernel wrapper that routes CPU tensors to its plain
version and refuses what the kernel does not take."""

import os
import re
import subprocess
import sys

import pytest
import torch

from oatomobile_torch.envs.batched import BatchedEnv
from oatomobile_torch.ops import bev_cuda

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(ROOT, "oatomobile_torch")


def test_import_and_rollout_without_jax():
  code = (
      "import sys\n"
      "from oatomobile_torch.envs.batched import BatchedEnv\n"
      "env = BatchedEnv('Town02', 2, num_vehicles=2, device='cpu')\n"
      "_, _, stats = env.rollout(2, compute=('lidar',))\n"
      "assert (stats['obs_checksum'] > 0).all()\n"
      "bad = [m for m in sys.modules if m.split('.')[0] in "
      "('jax', 'jaxlib', 'flax', 'optax', 'oatomobile_tpu')]\n"
      "assert not bad, bad\n"
      "print('clean')\n")
  env = dict(os.environ, PYTHONPATH=ROOT)
  proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                        capture_output=True, text=True, timeout=300,
                        check=False)
  assert proc.returncode == 0, proc.stderr
  assert proc.stdout.strip().endswith("clean")


def test_sources_never_import_jax():
  pattern = re.compile(
      r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|oatomobile_tpu)\b", re.M)
  for folder, _, files in os.walk(PACKAGE):
    for name in files:
      if name.endswith(".py"):
        with open(os.path.join(folder, name)) as fp:
          assert not pattern.search(fp.read()), name


def test_entry_points_default_to_cuda():
  if torch.cuda.is_available():
    pytest.skip("a CUDA device is present: the default is usable here")
  with pytest.raises(RuntimeError, match="device='cpu'"):
    BatchedEnv("Town02", 2)


def _inputs(B=2, nw=3, nr=2, nv=4, dtype=torch.float32):
  g = torch.Generator().manual_seed(0)
  make = lambda *s: torch.rand(*s, generator=g).to(dtype)  # pylint: disable=unnecessary-lambda-assignment
  return make(B, 4), make(B, nw, 6), make(B, nr, 6), make(B, nv, 6)


def test_wrapper_routes_cpu_tensors_to_plain_version():
  before = bev_cuda.launches
  inputs = _inputs()
  out = bev_cuda.splat_lidar_batch(*inputs)
  assert out.shape == (2, 200, 200, 2) and out.dtype == torch.float32
  assert torch.equal(out, bev_cuda.splat_lidar_batch_reference(*inputs))
  assert bev_cuda.launches == before  # no kernel ran


@pytest.mark.parametrize("bad", ["dtype", "rank", "batch", "width",
                                 "too_many_walls", "device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
  hero, walls, roads, boxes = _inputs()
  if bad == "dtype":
    walls = walls.double()
  elif bad == "rank":
    hero = hero[None]
  elif bad == "batch":
    roads = roads[:1]
  elif bad == "width":
    boxes = boxes[..., :5]
  elif bad == "too_many_walls":
    walls = torch.zeros(2, bev_cuda.MAX_WALLS + 1, 6)
  elif bad == "device":
    hero = hero.to("meta")
  with pytest.raises((TypeError, ValueError)):
    bev_cuda.splat_lidar_batch(hero, walls, roads, boxes)


def test_kernel_source_is_plain_cuda():
  with open(bev_cuda.SOURCE) as fp:
    source = fp.read()
  assert "#include <torch/" not in source
  assert "__fmul_rn" in source and 'extern "C"' in source
  assert "sm_90a" in " ".join(bev_cuda.NVCC_FLAGS)
