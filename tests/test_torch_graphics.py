"""oatomobile_torch.utils.graphics and what renders through it against the
JAX package on the CPU: every host-side rendering function on seeded
numpy inputs, the simulator's ``human`` dashboard, the Monitor and
LiveView wrappers, ``Benchmark.evaluate(monitor=True)``, the rule-based
CLIs, ``CARNOVEL.plot_benchmark`` and DIM's ``plot_every`` default."""

import inspect
import os
import subprocess
import sys

import imageio
import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use("Agg")

from oatomobile_torch.baselines.learned.dim import train as tdim  # pylint: disable=wrong-import-position
from oatomobile_torch.benchmarks.carnovel.benchmark import CARNOVEL  # pylint: disable=wrong-import-position
from oatomobile_torch.core.benchmark import Benchmark  # pylint: disable=wrong-import-position
from oatomobile_torch.datasets import CARLADataset  # pylint: disable=wrong-import-position
from oatomobile_torch.core.rl import (FiniteHorizonWrapper,  # pylint: disable=wrong-import-position
                                      LiveViewWrapper, MonitorWrapper,
                                      StepsMetric)
from oatomobile_torch.envs import CARLAEnv  # pylint: disable=wrong-import-position
from oatomobile_torch.utils import graphics as tgraphics  # pylint: disable=wrong-import-position
from oatomobile_tpu.baselines.learned.dim import train as jdim  # pylint: disable=wrong-import-position
from oatomobile_tpu.core.rl import \
    MonitorWrapper as JaxMonitorWrapper  # pylint: disable=wrong-import-position
from oatomobile_tpu.envs import CARLAEnv as JaxCARLAEnv  # pylint: disable=wrong-import-position
from oatomobile_tpu.utils import graphics as jgraphics  # pylint: disable=wrong-import-position
from test_torch_env import ACTIONS, SEED, _NullAgent  # pylint: disable=wrong-import-position

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The dashboard's panels come from the cameras, the bird view and the
# LIDAR of one scene whose floats agree to ~1e-5 (tests/test_torch_env.py):
# a pixel on an edge may fall either side, under 1e-3 of them.
PIXEL_FRACTION = 1e-3
ENV_KWARGS = dict(town="Town02", sensors=("goal", "velocity"), spawn_point=3,
                  destination=40, num_vehicles=2)


def _rs(seed=0):
  return np.random.RandomState(seed)


def _images():
  rs = _rs()
  return {
      "lidar": rs.uniform(0, 1, (200, 200, 2)).astype(np.float32),
      "rgb": rs.uniform(-0.2, 1.2, (180, 320, 3)).astype(np.float32),
      "rgb255": rs.randint(0, 256, (64, 48, 3)).astype(np.uint8),
      "gray": rs.uniform(0, 1, (50, 70)).astype(np.float32),
  }


@pytest.mark.parametrize("case", [
    "lidar_2darray_to_rgb", "downsample", "rgb_to_binary_mask",
    "rgb_to_binary_mask_255", "to_uint8", "resize_nearest"])
def test_array_functions_equal_the_jax_packages(case):
  images = _images()
  calls = {
      "lidar_2darray_to_rgb": ("lidar_2darray_to_rgb", (images["lidar"],)),
      "downsample": ("downsample", (images["rgb"], 3)),
      "rgb_to_binary_mask": ("rgb_to_binary_mask", (images["rgb"], 0.4)),
      "rgb_to_binary_mask_255": ("rgb_to_binary_mask", (images["rgb255"],)),
      "to_uint8": ("_to_uint8", (images["rgb"],)),
      "resize_nearest": ("_resize_nearest", (images["rgb255"], 37, 91)),
  }
  name, args = calls[case]
  want = getattr(jgraphics, name)(*args)
  got = getattr(tgraphics, name)(*args)
  assert got.dtype == want.dtype and got.shape == want.shape
  np.testing.assert_array_equal(got, want)


HUDS = {
    "no_hud": None,
    "hud": dict(speed_mps=7.3, step=41, collided=False, throttle=0.6,
                steer=-0.3, brake=0.0),
    "hud_collided": dict(speed_mps=0.4, step=7, collided=True, throttle=0.0,
                         steer=0.9, brake=1.0),
}


@pytest.mark.parametrize("hud", list(HUDS))
def test_compose_dashboard_frame_is_exact(hud):
  images = _images()
  panels = {"camera": images["rgb"], "lidar": images["lidar"],
            "small": images["rgb255"], "gray": images["gray"]}
  want = jgraphics.compose_dashboard_frame(panels, HUDS[hud])
  got = tgraphics.compose_dashboard_frame(panels, HUDS[hud])
  assert got.dtype == want.dtype == np.uint8
  assert got.shape == (240 + (36 if HUDS[hud] else 0), 4 * 240, 3)
  np.testing.assert_array_equal(got, want)


def test_hud_without_pil_is_bars_only(monkeypatch):
  monkeypatch.setitem(sys.modules, "PIL", None)  # import PIL raises
  want = jgraphics._hud_strip(HUDS["hud_collided"], 720)  # pylint: disable=protected-access
  got = tgraphics._hud_strip(HUDS["hud_collided"], 720)  # pylint: disable=protected-access
  np.testing.assert_array_equal(got, want)
  # The text's light pixels are absent: only the bars' colours and the
  # background.
  assert got.shape == (36, 720, 3) and not (got > 230).all(-1).any()


def _canvas(fig) -> np.ndarray:
  fig.canvas.draw()
  return np.asarray(fig.canvas.buffer_rgba()).copy()


@pytest.mark.parametrize("name", ["make_dashboard",
                                  "plot_trajectory_overlay"])
def test_figures_equal_the_jax_packages(name, tmp_path):
  import matplotlib.pyplot as plt  # pylint: disable=import-outside-toplevel
  images = _images()
  rs = _rs(1)
  trajectories = {"sample": rs.normal(0, 5, (4, 2)),
                  "ground_truth": rs.normal(0, 5, (4, 2))}
  args = {"make_dashboard": (
      {"bird_view_camera_rgb": images["rgb"], "lidar": images["lidar"]},),
          "plot_trajectory_overlay": (images["lidar"], trajectories)}[name]
  figs = []
  for module, tag in ((jgraphics, "jax"), (tgraphics, "torch")):
    fname = str(tmp_path / "{}.png".format(tag))
    figs.append(getattr(module, name)(*args, output_fname=fname))
    assert os.path.getsize(fname) > 0
  want, got = (_canvas(f) for f in figs)
  for f in figs:
    plt.close(f)
  np.testing.assert_array_equal(got, want)


def test_live_viewer_is_a_no_op_under_agg():
  viewer = tgraphics.LiveViewer(refresh_hz=1000.0)
  frame = np.zeros((8, 8, 3), np.uint8)
  viewer.show(frame)
  viewer.show(frame)
  assert viewer._fig is None and viewer._dead  # pylint: disable=protected-access
  viewer.close()


def _envs():
  jenv = JaxCARLAEnv(**ENV_KWARGS)
  tenv = CARLAEnv(**ENV_KWARGS, device="cpu")
  for env in (jenv, tenv):
    env.seed(SEED)
  return jenv, tenv


def test_human_render_matches_the_jax_simulator():
  frames = []
  for env in _envs():
    env.reset()
    for action in ACTIONS[:3]:
      env.step(action)
    frames.append(env.render(mode="human"))
    env.close()
  want, got = frames
  assert got.shape == want.shape == (276, 720, 3)
  assert got.dtype == want.dtype == np.uint8
  differing = np.any(got != want, axis=-1).mean()
  assert differing < PIXEL_FRACTION, differing
  # The three panels are not empty.
  for i in range(3):
    assert got[:240, 240 * i:240 * (i + 1)].max() > 0, i


def test_monitor_gif_equals_the_jax_wrappers(tmp_path):
  gifs = []
  for wrapper, env, tag in zip((JaxMonitorWrapper, MonitorWrapper), _envs(),
                               ("jax", "torch")):
    fname = str(tmp_path / "{}.gif".format(tag))
    # The dashboard (its HUD counts the steps): a GIF writer merges equal
    # frames, and the bird view barely moves in four steps.
    env = wrapper(env, output_fname=fname, render_mode="human",
                  record_every=2)
    env.reset()
    for action in ACTIONS[:4]:
      env.step(action)
    env.close()
    gifs.append(np.asarray(imageio.mimread(fname)))
  want, got = gifs
  # Reset and four steps are five frames; every second one is kept.
  assert got.shape == want.shape and got.shape[0] == 3
  differing = np.any(got != want, axis=-1).mean()
  assert differing < PIXEL_FRACTION, differing


def test_live_view_wrapper_steps_headless():
  _, env = _envs()
  env = LiveViewWrapper(FiniteHorizonWrapper(env, max_episode_steps=2))
  env.reset()
  _, _, done, _ = env.step(ACTIONS[0])
  _, _, done, _ = env.step(ACTIONS[1])
  assert done
  env.close()


def test_benchmark_evaluate_with_monitor_writes_video(tmp_path):

  class _Bench(Benchmark):

    @property
    def tasks(self):
      return {"town02-v0": lambda: CARLAEnv(**ENV_KWARGS, device="cpu")}

    @property
    def metrics(self):
      return [StepsMetric()]

  bench = _Bench()
  bench.load = lambda task_id: FiniteHorizonWrapper(
      bench.tasks[task_id](), max_episode_steps=3)
  bench.evaluate(_NullAgent, log_dir=str(tmp_path), monitor=True)
  task_dir = tmp_path / "town02-v0"
  frames = imageio.mimread(str(task_dir / "video.gif"))
  assert frames and frames[0].shape == (200, 200, 3)
  with open(str(task_dir / "metrics.csv")) as fp:
    assert fp.read() == "steps\n3\n"


def test_collect_with_render_writes_the_episode(tmp_path):
  """``CARLADataset.collect(render=True)`` renders the dashboard every
  step through the loop and still writes one npz a step."""
  CARLADataset.collect("Town02", str(tmp_path), num_vehicles=0,
                       num_pedestrians=0, num_steps=3, spawn_point=3,
                       destination=40, render=True, device="cpu")
  (episode,) = os.listdir(str(tmp_path))
  assert len([f for f in os.listdir(str(tmp_path / episode))
              if f.endswith(".npz")]) == 4  # reset + 3 steps


@pytest.mark.parametrize("agent,flags", [
    ("autopilot", ["--monitor_fname", "run.gif"]),
    ("blind", ["--live"]),
])
def test_rulebased_cli_runs(agent, flags, tmp_path):
  env = dict(os.environ, PYTHONPATH=ROOT, MPLBACKEND="Agg")
  proc = subprocess.run(
      [sys.executable, "-m",
       "oatomobile_torch.baselines.rulebased.{}.run".format(agent), "--cpu",
       "--town", "Town02", "--num_steps", "5"] + flags,
      cwd=str(tmp_path), env=env, capture_output=True, text=True,
      timeout=300, check=False)
  assert proc.returncode == 0, proc.stderr
  assert "'steps': 5" in proc.stdout
  if agent == "autopilot":  # a GIF writer merges equal frames
    frames = imageio.mimread(str(tmp_path / "run.gif"))
    assert frames and frames[0].shape == (200, 200, 3)


def test_plot_benchmark_writes_a_png_per_task(tmp_path):
  CARNOVEL(device="cpu").plot_benchmark(str(tmp_path))
  names = sorted(os.listdir(str(tmp_path)))
  assert len(names) == 27 and all(n.endswith("-v0.png") for n in names)
  image = imageio.v2.imread(str(tmp_path / names[0]))
  assert image.ndim == 3 and image.std() > 0


def test_dim_plot_every_defaults_as_jax():
  want = inspect.signature(jdim.train).parameters["plot_every"].default
  assert inspect.signature(tdim.train).parameters[
      "plot_every"].default == want == 4
