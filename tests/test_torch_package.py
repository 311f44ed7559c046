"""Package rules of oatomobile_torch: no JAX anywhere, the card by
default, and a kernel wrapper that routes CPU tensors to its plain
version and refuses what the kernel does not take."""

import os
import re
import subprocess
import sys

import pytest
import torch

from oatomobile_torch.baselines.learned.cil import train as cil_train
from oatomobile_torch.baselines.learned.dim import train as dim_train
from oatomobile_torch.baselines.learned.rip import train as rip_train
from oatomobile_torch.benchmarks.batched_eval import evaluate_batched
from oatomobile_torch.datasets import CARLADataset
from oatomobile_torch.envs.batched import BatchedEnv
from oatomobile_torch.envs.carla import CARLAEnv, CARLANavEnv
from oatomobile_torch.maps import load_town
from oatomobile_torch.models import (MLP, AutoregressiveFlow,
                                     BehaviouralModel, ImitativeModel,
                                     MobileNetV2)
from oatomobile_torch.ops import bev_cuda
from oatomobile_torch.sim import make_params
from oatomobile_torch.simulators.cuda import CUDASimulator

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(ROOT, "oatomobile_torch")


def test_import_and_rollout_without_jax():
  code = (
      "import os, sys\n"
      "from oatomobile_torch.envs.batched import BatchedEnv\n"
      "from oatomobile_torch import models\n"
      "from oatomobile_torch.models import convert\n"
      "from oatomobile_torch.baselines.learned import bridge\n"
      "from oatomobile_torch.baselines.learned.dim.policy import "
      "make_dim_policy\n"
      "from oatomobile_torch.baselines.learned.rip.policy import "
      "make_rip_policy\n"
      "from oatomobile_torch.baselines.learned.cil.policy import "
      "make_cil_policy\n"
      "import oatomobile_torch\n"
      "from oatomobile_torch.benchmarks import carnovel, corl2017, run\n"
      "from oatomobile_torch.benchmarks.batched_eval import "
      "evaluate_batched\n"
      "from oatomobile_torch.envs.carla import CARLANavEnv\n"
      "from oatomobile_torch.simulators.cuda import CUDASimulator\n"
      "from oatomobile_torch.baselines.rulebased import AutopilotAgent, "
      "BlindAgent\n"
      "from oatomobile_torch.baselines.learned import CILAgent, DIMAgent, "
      "RIPAgent\n"
      "from oatomobile_torch.benchmarks.corl2017.benchmark import _TASKS\n"
      "from oatomobile_torch.datasets import CARLADataset\n"
      "from oatomobile_torch.baselines.learned.dim import train\n"
      "from oatomobile_torch.baselines.learned.cil import train\n"
      "from oatomobile_torch.baselines.learned.rip import train\n"
      "from oatomobile_torch.utils import checkpoint, flax_msgpack\n"
      "from oatomobile_torch.utils import loggers, profiling\n"
      "from oatomobile_torch import graphs\n"
      "from oatomobile_torch.parallel import dp\n"
      "from oatomobile_torch.parallel import mesh\n"
      "from oatomobile_torch.envs.multi_town import MultiTownBatchedEnv\n"
      "from oatomobile_torch.sensors import cameras\n"
      "from oatomobile_torch.utils import graphics\n"
      "from oatomobile_torch.baselines.rulebased.autopilot import run\n"
      "from oatomobile_torch.baselines.rulebased.blind import run\n"
      "from oatomobile_torch.experiments import (eval_carnovel_agents, "
      "headtohead, pipeline, publish, round5, train_in_the_loop)\n"
      "from oatomobile_torch.experiments import (demo_dashboard, "
      "demo_full_loop, profile_flow, rip_sweep, study_dim50, "
      "train_dim_full)\n"
      "from oatomobile_torch.experiments import diag\n"
      "from oatomobile_torch.experiments.diag import (busytown, "
      "busytown_viz, common, hero_stops, hills, hills_viz, "
      "learned_failures, stalls, town02)\n"
      "from oatomobile_torch import entry\n"
      "from oatomobile_torch.experiments import (post_round2, publish_r3, "
      "publish_r4, round2, round3)\n"
      "fn, example = entry.entry('cpu')\n"
      "assert float(entry.capture(fn, example)(*example)) > 0\n"
      "tasks = {t: dict(_TASKS[t], num_vehicles=2) for t in "
      "('Town02_Turn0-v0', 'Town02_Straight0-v0')}\n"
      "out = evaluate_batched(tasks, horizon=2, device='cpu')\n"
      "assert sorted(out) == sorted(tasks), out\n"
      "assert all(r['steps'] == 2 for r in out.values()), out\n"
      "env = BatchedEnv('Town02', 2, num_vehicles=2, device='cpu')\n"
      "_, _, stats = env.rollout(2, compute=('lidar',))\n"
      "assert (stats['obs_checksum'] > 0).all()\n"
      "policy = make_dim_policy(models.ImitativeModel(device='cpu'), "
      "num_plan_steps=2)\n"
      "_, _, stats = env.rollout(1, policy=policy)\n"
      "assert (stats['distance'] > 0).all()\n"
      "bad = [m for m in sys.modules if m.split('.')[0] in "
      "('jax', 'jaxlib', 'flax', 'optax', 'msgpack', 'oatomobile_tpu')]\n"
      "assert not bad, bad\n"
      "scripts = os.path.join(os.getcwd(), 'scripts')\n"
      "bad = [m for m, mod in list(sys.modules.items()) if "
      "(getattr(mod, '__file__', None) or '').startswith(scripts)]\n"
      "assert not bad, bad\n"
      "assert '__graft_entry__' not in sys.modules\n"
      "print('clean')\n")
  env = dict(os.environ, PYTHONPATH=ROOT)
  proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                        capture_output=True, text=True, timeout=300,
                        check=False)
  assert proc.returncode == 0, proc.stderr
  assert proc.stdout.strip().endswith("clean")


def test_rendering_modules_import_without_matplotlib():
  """The card's machine has no matplotlib, PIL or imageio: the modules
  that render import them inside the functions that draw."""
  code = (
      "import sys\n"
      "from oatomobile_torch.sensors import cameras, synth\n"
      "from oatomobile_torch.utils import graphics\n"
      "from oatomobile_torch.core import rl\n"
      "from oatomobile_torch.simulators.cuda import CUDASimulator\n"
      "from oatomobile_torch.benchmarks.carnovel.benchmark import CARNOVEL\n"
      "from oatomobile_torch.baselines.learned.dim import train\n"
      "from oatomobile_torch.baselines.rulebased.autopilot import run\n"
      "from oatomobile_torch.baselines.rulebased.blind import run\n"
      "from oatomobile_torch.experiments import (eval_carnovel_agents, "
      "headtohead, pipeline, publish, round5, train_in_the_loop)\n"
      "from oatomobile_torch.experiments import (demo_dashboard, "
      "demo_full_loop, profile_flow, rip_sweep, study_dim50, "
      "train_dim_full)\n"
      "from oatomobile_torch.experiments import diag\n"
      "from oatomobile_torch.experiments.diag import (busytown, "
      "busytown_viz, common, hero_stops, hills, hills_viz, "
      "learned_failures, stalls, town02)\n"
      "from oatomobile_torch import entry\n"
      "from oatomobile_torch.experiments import (post_round2, publish_r3, "
      "publish_r4, round2, round3)\n"
      "bad = [m for m in sys.modules if m.split('.')[0] in "
      "('matplotlib', 'PIL', 'imageio', 'jax', 'oatomobile_tpu')]\n"
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
      r"^\s*(import|from)\s+"
      r"(jax|jaxlib|flax|optax|msgpack|oatomobile_tpu)\b", re.M)
  for folder, _, files in os.walk(PACKAGE):
    for name in files:
      if name.endswith(".py"):
        with open(os.path.join(folder, name)) as fp:
          assert not pattern.search(fp.read()), name


def test_sources_never_import_scripts():
  """The port copies what it needs from the JAX package's ``scripts/`` and
  the repository's ``__graft_entry__.py``: no module of it (nor
  ``chip_smoke.py``) imports one of them or puts them on the path."""
  pattern = re.compile(
      r"^\s*(import|from)\s+(scripts|__graft_entry__)\b"
      r"|['\"](scripts|__graft_entry__(\.py)?)['\"]", re.M)
  paths = [os.path.join(ROOT, "chip_smoke.py")]
  for folder, _, files in os.walk(PACKAGE):
    paths += [os.path.join(folder, name) for name in files
              if name.endswith(".py")]
  assert os.path.join(PACKAGE, "entry.py") in paths
  for path in paths:
    with open(path) as fp:
      assert not pattern.search(fp.read()), path


def test_entry_points_default_to_cuda(tmp_path):
  if torch.cuda.is_available():
    pytest.skip("a CUDA device is present: the default is usable here")
  with pytest.raises(RuntimeError, match="device='cpu'"):
    BatchedEnv("Town02", 2)
  # The models that make_dim_policy, make_rip_policy and make_cil_policy
  # take, and each of their parts.
  for make in (ImitativeModel, BehaviouralModel, MobileNetV2,
               AutoregressiveFlow, lambda: MLP(3, (4,))):
    with pytest.raises(RuntimeError, match="device='cpu'"):
      make()
  # The evaluator, the single-scene env and its simulator, the world's
  # parameters.
  task = {"t-v0": {"town": "Town02", "origin": 1, "destination": 9}}
  for make in (lambda: evaluate_batched(task, horizon=1),
               lambda: CARLANavEnv(town="Town02", origin=1, destination=9),
               lambda: CARLAEnv(town="Town02"),
               lambda: CUDASimulator("Town02"),
               lambda: make_params(load_town("Town02"))):
    with pytest.raises(RuntimeError, match="device='cpu'"):
      make()
  # Collection and the trainers (they fail before reading any data).
  out = str(tmp_path)
  for make in (lambda: CARLADataset.collect_packed("Town02", out),
               lambda: dim_train.train(out, out),
               lambda: cil_train.train(out, out),
               lambda: rip_train.train(out, out)):
    with pytest.raises(RuntimeError, match="device='cpu'"):
      make()


def test_diagnostics_and_studies_default_to_cuda(tmp_path):
  if torch.cuda.is_available():
    pytest.skip("a CUDA device is present: the default is usable here")
  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.experiments import profile_flow, study_dim50
  from oatomobile_torch.experiments.diag import hero_stops, learned_failures
  for make in (lambda: hero_stops.run(scenes=1, horizon=1),
               lambda: learned_failures.run("autopilot", horizon=1,
                                            max_tasks=1),
               lambda: profile_flow.run(2, 1),
               lambda: study_dim50.run(out=str(tmp_path), epochs=1)):
    with pytest.raises(RuntimeError, match="device='cpu'"):
      make()


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
  source = ""
  for path in (bev_cuda.SOURCE, *bev_cuda.HEADERS):
    with open(path) as fp:
      source += fp.read()
  assert "#include <torch/" not in source
  assert "__fmul_rn" in source and 'extern "C"' in source
  assert "sm_90a" in " ".join(bev_cuda.NVCC_FLAGS)
