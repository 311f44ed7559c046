"""oatomobile_torch.sensors.cameras and the game-state masks of
oatomobile_torch.sensors.synth against the JAX package on the CPU: the
class images of the four cameras, their RGB and CityScapes palettes, the
pixel rays, the 64 m and the whole-town game state, and the five keys
served through ``synthesize``, ``BatchedEnv.rollout`` (captured and
eager) and ``collect_packed``."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oatomobile_torch import sim as tsim
from oatomobile_torch.datasets.carla import CARLADataset
from oatomobile_torch.envs.batched import BatchedEnv
from oatomobile_torch.maps import load_town as torch_load_town
from oatomobile_torch.ops import bev_cuda
from oatomobile_torch.sensors import cameras as tcam
from oatomobile_torch.sensors import synth as tsynth
from oatomobile_torch.sim import types as ttypes
from oatomobile_tpu import sim as jsim
from oatomobile_tpu.datasets.carla import CARLADataset as JaxCARLADataset
from oatomobile_tpu.envs.batched import BatchedEnv as JaxBatchedEnv
from oatomobile_tpu.maps import load_town as jax_load_town
from oatomobile_tpu.sensors import cameras as jcam
from oatomobile_tpu.sensors import synth as jsynth
from test_torch_compiled import fake_card  # pylint: disable=unused-import
from test_torch_compiled import _run, assert_trees_equal
from torch_port_helpers import jax_state_to_numpy

torch.set_num_threads(1)

YAWS = (0.0, 90.0, 180.0, 270.0)
CAMERA_KEYS = ("front_camera_rgb", "rear_camera_rgb", "left_camera_rgb",
               "right_camera_rgb")
FIVE_KEYS = CAMERA_KEYS + ("game_state",)
# A pixel's class comes from ray distances compared with each other and
# with the surfaces' heights; XLA's FMA and the last ulp of cos/sin move a
# ray grazing an edge to the other side: under 1e-3 of the pixels (as the
# bird view, tests/test_torch_sensors.py).
PIXEL_FRACTION = 1e-3


def _jax_scenes(town, num_vehicles, num_pedestrians, batch, steps):
  jt = jax_load_town(town)
  jp = jsim.make_params(jt)
  states = jsim.init_scene_batch(jt, batch, num_vehicles=num_vehicles,
                                 num_pedestrians=num_pedestrians, seed=2)
  policy = jax.jit(jax.vmap(lambda s: jsim.autopilot_policy(jp, s)))
  step = jax.jit(jax.vmap(jsim.world_step, in_axes=(None, 0, 0)))
  for _ in range(steps):
    action, states = policy(states)
    states = step(jp, states, action)
  return jp, states


def _torch_scenes(town, states):
  tp = tsim.make_params(torch_load_town(town), device="cpu")
  return tp, ttypes.scene_state_from_numpy(jax_state_to_numpy(states),
                                           "cpu")


@pytest.fixture(scope="module", params=[("Town02", 6, 2), ("Town03", 8, 4)],
                ids=lambda c: "{}-{}v-{}p".format(*c))
def scenes(request):
  """3 scenes after 40 autopilot steps (tests/test_torch_sensors.py)."""
  town, num_vehicles, num_pedestrians = request.param
  jp, states = _jax_scenes(town, num_vehicles, num_pedestrians, 3, 40)
  return (town, jp, states) + _torch_scenes(town, states)


@pytest.fixture(scope="module")
def actor_scenes():
  """Two Town03 scenes with 6 NPCs and 6 pedestrians each placed around
  the hero (tests/test_torch_sensors.py's bird-view actor scene)."""
  jt = jax_load_town("Town03")
  jp = jsim.make_params(jt)
  states = jsim.init_scene_batch(jt, 2, num_vehicles=6, num_pedestrians=6,
                                 seed=3)
  rs = np.random.RandomState(0)
  hero = np.asarray(states.hero_xy)[:, None, :]
  states = states.replace(
      npc_xy=jnp.asarray(hero + rs.uniform(-15, 15, (2, 6, 2)),
                         jnp.float32),
      npc_yaw=jnp.asarray(rs.uniform(-3, 3, (2, 6)), jnp.float32),
      ped_xy=jnp.asarray(hero + rs.uniform(-15, 15, (2, 6, 2)),
                         jnp.float32),
      ped_yaw=jnp.asarray(rs.uniform(-3, 3, (2, 6)), jnp.float32))
  return (jp, states) + _torch_scenes("Town03", states)


def _jax_batch(fn, jp, states, *args):
  """``fn(params, scene, *args)`` of the JAX package over the scene batch,
  jitted whole (op by op, XLA compiles every broadcast separately)."""
  return np.asarray(jax.jit(jax.vmap(
      lambda s: fn(jp, s, *args)))(states))


def _jax_classes(jp, states, yaw):
  return _jax_batch(jcam.camera_classes, jp, states, yaw)


def _assert_classes_match(got, want):
  assert got.shape == want.shape == (want.shape[0], 180, 320)
  assert got.dtype == want.dtype == np.int32
  assert np.mean(got != want) < PIXEL_FRACTION, np.mean(got != want)
  # Every class the JAX image shows is in the port's, at its pixels.
  for code in np.unique(want):
    assert ((got == code) & (want == code)).any(), code


@pytest.mark.parametrize("yaw", YAWS)
def test_camera_classes_match(scenes, yaw):
  _, jp, states, tp, ts = scenes
  want = _jax_classes(jp, states, yaw)
  _assert_classes_match(tcam.camera_classes(tp, ts, yaw).numpy(), want)
  if yaw == 0.0:  # the front view: sky, ground, road and buildings
    assert {tcam.SKY, tcam.GROUND, tcam.ROAD, tcam.BUILDING} <= set(
        np.unique(want).tolist())


@pytest.mark.parametrize("yaw", YAWS)
def test_camera_classes_draw_actors(actor_scenes, yaw):
  jp, states, tp, ts = actor_scenes
  _assert_classes_match(tcam.camera_classes(tp, ts, yaw).numpy(),
                        _jax_classes(jp, states, yaw))


def test_actor_scenes_show_vehicles_and_pedestrians(actor_scenes):
  jp, states, _, _ = actor_scenes
  seen = set()
  for yaw in YAWS:
    seen |= set(np.unique(_jax_classes(jp, states, yaw)).tolist())
  assert {tcam.VEHICLE, tcam.PED} <= seen


@pytest.mark.parametrize("name", ["camera_rgb", "camera_cityscapes"])
def test_palettes_are_exact_given_the_classes(scenes, name):
  _, jp, states, tp, ts = scenes
  palette = {"camera_rgb": jcam._RGB,  # pylint: disable=protected-access
             "camera_cityscapes": jcam._CITYSCAPES}[name]  # pylint: disable=protected-access
  got = getattr(tcam, name)(tp, ts, 90.0).numpy()
  classes = tcam.camera_classes(tp, ts, 90.0).numpy()
  assert got.dtype == np.float32 and got.shape == (3, 180, 320, 3)
  np.testing.assert_array_equal(got, palette[classes])
  want = _jax_batch(getattr(jcam, name), jp, states, 90.0)
  assert np.any(got != want, axis=-1).mean() < PIXEL_FRACTION


def test_pixel_rays_are_jnp_linspace():
  want_u, want_w = jcam._pixel_rays()  # pylint: disable=protected-access
  u, w = tcam._pixel_rays("cpu")  # pylint: disable=protected-access
  # XLA rounds start * (1 - t) + stop * t its own way: a few ulps of the
  # unit half-width (tests/test_torch_sensors.py's bird-view axis).
  np.testing.assert_allclose(u.numpy(), np.asarray(want_u)[0], rtol=0,
                             atol=4e-6)
  np.testing.assert_allclose(w.numpy(), np.asarray(want_w)[:, 0], rtol=0,
                             atol=4e-6)


def _assert_masks_match(got, want):
  assert got.shape == want.shape and got.dtype == want.dtype == np.int32
  for c in range(8):
    assert np.mean(got[..., c] != want[..., c]) < PIXEL_FRACTION, c


def test_game_state_matches(scenes):
  _, jp, states, tp, ts = scenes
  want = _jax_batch(jsynth.game_state, jp, states)
  got = tsynth.game_state(tp, ts).numpy()
  assert got.shape == (3, 320, 320, 8)
  _assert_masks_match(got, want)
  # Road, lane and hero channels are set in every scene.
  assert (want[..., [0, 1, 7]].sum((1, 2)) > 0).all()


def test_game_state_draws_actors(actor_scenes):
  jp, states, tp, ts = actor_scenes
  want = _jax_batch(jsynth.game_state, jp, states)
  _assert_masks_match(tsynth.game_state(tp, ts).numpy(), want)
  assert (want[..., 2].sum((1, 2)) > 0).all()  # vehicles
  assert (want[..., 3].sum((1, 2)) > 0).all()  # pedestrians


def test_full_town_game_state_matches():
  jp, states = _jax_scenes("Town02", 6, 2, 2, 40)
  tp, ts = _torch_scenes("Town02", states)
  want = _jax_batch(jsynth.full_town_game_state, jp, states)
  got = tsynth.full_town_game_state(tp, ts).numpy()
  assert got.shape == (2,) + tuple(tp.map["road_mask"].shape) + (8,)
  _assert_masks_match(got, want)
  # Lights in each phase show somewhere over the town.
  assert want[..., 4:7].sum() > 0 and want[..., 2].sum() > 0


def test_synthesize_serves_the_five_keys(scenes):
  _, jp, states, tp, ts = scenes
  want = jax.jit(jax.vmap(
      lambda s: jsynth.synthesize(jp, s, FIVE_KEYS)))(states)
  got = tsynth.synthesize(tp, ts, FIVE_KEYS)
  assert set(got) == set(FIVE_KEYS)
  for key in FIVE_KEYS:
    w, g = np.asarray(want[key]), got[key].numpy()
    assert g.shape == w.shape and g.dtype == w.dtype, key
    assert np.any(g != w, axis=-1).mean() < PIXEL_FRACTION, key


def test_rollout_collects_the_five_keys_as_jax():
  kwargs = dict(num_vehicles=4, num_pedestrians=2, seed=5, sensors=FIVE_KEYS)
  _, want, _ = JaxBatchedEnv("Town02", 2, **kwargs).rollout(
      5, collect=FIVE_KEYS)
  _, got, _ = BatchedEnv("Town02", 2, device="cpu", **kwargs).rollout(
      5, collect=FIVE_KEYS)
  for key in FIVE_KEYS:
    w, g = np.asarray(want[key]), got[key].numpy()
    assert g.shape == w.shape == (5, 2) + w.shape[2:], key
    assert g.dtype == w.dtype, key
    assert np.any(g != w, axis=-1).mean() < PIXEL_FRACTION, key


@pytest.mark.parametrize("card", [False, True], ids=["cpu", "fake_card"])
def test_captured_rollout_serves_the_five_keys(card, request):
  """The runner's step (captured on a card) equals the eager loop exactly
  with the five keys collected and a camera and the LIDAR computed."""
  if card:
    request.getfixturevalue("fake_card")
  kwargs = dict(num_vehicles=4, num_pedestrians=2, seed=3, sensors=FIVE_KEYS,
                auto_reset=False)
  rollout = dict(collect=FIVE_KEYS, compute=("front_camera_rgb", "lidar"))
  runner, eager = (BatchedEnv("Town02", 2, device="cpu", **kwargs)
                   for _ in range(2))
  got = _run(runner, True, 4, **rollout)
  if card:
    assert bev_cuda.KERNEL.launches == 4  # the computed LIDAR, once a step
  want = _run(eager, False, 4, **rollout)
  for g, w in zip(got, want):
    assert_trees_equal(g, w)
  assert got[1]["game_state"].shape == (4, 2, 320, 320, 8)


def test_collect_packed_with_cameras_matches_jax(tmp_path):
  """Packed collection of the front camera and the game state at 32x32
  (windows cut to 5 past and 10 future steps to fit 30 steps)."""
  kwargs = dict(num_episodes=2, num_steps=30, past_length=5,
                future_length=10, num_vehicles=4, seed=1,
                modalities=("lidar", "velocity", "front_camera_rgb",
                            "game_state"),
                image_size=(32, 32))
  dirs = {name: str(tmp_path / name) for name in ("jax", "torch")}
  want_n = JaxCARLADataset.collect_packed("Town02", dirs["jax"], **kwargs)
  got_n = CARLADataset.collect_packed("Town02", dirs["torch"], device="cpu",
                                      **kwargs)
  assert got_n == want_n > 0
  for key in ("front_camera_rgb", "game_state"):
    want, got = (np.load(os.path.join(dirs[name], key + ".npy"))
                 for name in ("jax", "torch"))
    assert got.dtype == want.dtype == np.uint8, key
    assert got.shape == want.shape == (want_n, 32, 32, want.shape[-1]), key
    beyond = np.abs(got.astype(int) - want.astype(int)) > 1
    assert beyond.mean() < PIXEL_FRACTION, (key, beyond.mean())
