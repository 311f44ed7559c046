"""The port's last small public functions against the JAX package's on the
CPU: MobileNetV2's ``width_mult``, the planar transforms and
``yaw_to_forward``, ``stack_scenes`` and ``batched_world_step``,
``hero_yaw_deg``, ``build_grid_town`` and ``PIDState.zero``.

Tolerances: MobileNetV2 within 1e-4 of its largest feature (as
``tests/test_torch_models.py``); transforms within 1e-5 (float32 sin, cos
and products); one world step within 1e-5 (``tests/test_torch_sim.py``);
everything else exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oatomobile_torch import models as tmodels
from oatomobile_torch.maps import builder as tbuilder
from oatomobile_torch.maps import load_town as torch_load_town
from oatomobile_torch.maps.towns import _GRIDS as TORCH_GRIDS
from oatomobile_torch.models import convert
from oatomobile_torch.models.perception import channels_of
from oatomobile_torch.ops import transforms as ttf
from oatomobile_torch.sensors import synth as tsynth
from oatomobile_torch.sim import types as ttypes
from oatomobile_torch.sim import world as tworld
from oatomobile_tpu import models as jmodels
from oatomobile_tpu import sim as jsim
from oatomobile_tpu.maps import builder as jbuilder
from oatomobile_tpu.maps import load_town as jax_load_town
from oatomobile_tpu.maps.towns import _GRIDS as JAX_GRIDS
from oatomobile_tpu.ops import transforms as jtf
from oatomobile_tpu.sensors import synth as jsynth
from oatomobile_tpu.sim import types as jtypes
from test_torch_models import random_tree, scaled_err
from torch_port_helpers import (assert_states_match, jax_state_to_numpy)

torch.set_num_threads(1)

ATOL = 1e-5


@pytest.mark.parametrize("width_mult", [0.5, 1.0])
def test_mobilenet_width_mult_matches(width_mult):
  jm = jmodels.MobileNetV2(num_classes=128, width_mult=width_mult)
  tree = random_tree(jm, jnp.zeros((1, 64, 64, 2)), seed=3)
  tm = convert.load(tmodels.MobileNetV2(2, 128, width_mult=width_mult,
                                        device="cpu"), tree)
  x = np.random.RandomState(5).uniform(size=(2, 64, 64, 2)).astype(
      np.float32)
  want = np.asarray(jm.apply(tree, x))
  got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).detach().numpy()
  assert got.shape == want.shape == (2, 128)
  assert scaled_err(got, want) < 1e-4
  assert tm.head_conv.out_channels == channels_of(1280, width_mult)


def test_channel_rounding_is_the_jax_modules():
  for width_mult in (0.25, 0.35, 0.5, 0.75, 1.0, 1.3):
    jm = jmodels.MobileNetV2(num_classes=8, width_mult=width_mult)
    shapes = jax.eval_shape(lambda m=jm: m.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 2))))["params"]
    assert shapes["stem"]["kernel"].shape[-1] == channels_of(32, width_mult)
    assert shapes["head_conv"]["kernel"].shape[-1] == channels_of(
        1280, width_mult)


@pytest.mark.parametrize("as_torch", [False, True], ids=["numpy", "torch"])
def test_planar_transforms_match(as_torch):
  rs = np.random.RandomState(0)
  xy = rs.uniform(-100, 100, (4, 2)).astype(np.float32)
  yaw = rs.uniform(-np.pi, np.pi, (4,)).astype(np.float32)
  pts = rs.uniform(-100, 100, (4, 6, 2)).astype(np.float32)
  wrap = torch.from_numpy if as_torch else (lambda a: a)
  local = ttf.world2local_2d(current_xy=wrap(xy), current_yaw_rad=wrap(yaw),
                             world_xy=wrap(pts))
  back = ttf.local2world_2d(current_xy=wrap(xy), current_yaw_rad=wrap(yaw),
                            local_xy=local)
  want = jtf.world2local_2d(current_xy=jnp.asarray(xy),
                            current_yaw_rad=jnp.asarray(yaw),
                            world_xy=jnp.asarray(pts))
  want_back = jtf.local2world_2d(current_xy=jnp.asarray(xy),
                                 current_yaw_rad=jnp.asarray(yaw),
                                 local_xy=want)
  assert isinstance(local, torch.Tensor) == as_torch
  np.testing.assert_allclose(np.asarray(local), np.asarray(want), atol=ATOL)
  np.testing.assert_allclose(np.asarray(back), np.asarray(want_back),
                             atol=1e-4)
  np.testing.assert_allclose(np.asarray(back), pts, atol=1e-4)
  yaw_deg = rs.uniform(-360, 360, (5,)).astype(np.float32)
  fwd = ttf.yaw_to_forward(wrap(yaw_deg))
  np.testing.assert_allclose(np.asarray(fwd),
                             np.asarray(jtf.yaw_to_forward(yaw_deg)),
                             atol=ATOL)
  np.testing.assert_allclose(np.asarray(ttf.yaw_to_forward(90.0)),
                             [0.0, 1.0, 0.0], atol=1e-6)


@pytest.fixture(scope="module")
def towns():
  jt, tt = jax_load_town("Town02"), torch_load_town("Town02")
  return jt, jsim.make_params(jt), tt, tworld.make_params(tt, device="cpu")


def test_stack_scenes_and_batched_world_step_match(towns):
  jt, jp, tt, tp = towns
  seeds = (3, 5, 7)
  kwargs = dict(spawn_point=5, destination=20, num_vehicles=3)
  jstates = jsim.world.stack_scenes([
      jsim.init_scene(jt, jax_seed=s, **kwargs) for s in seeds])
  singles = [tworld.init_scene(tt, jax_seed=s, device="cpu", **kwargs)
             for s in seeds]
  tstates = tworld.stack_scenes(singles)
  assert tstates.batch_size == 3
  for i, single in enumerate(singles):
    assert torch.equal(tstates.hero_xy[i:i + 1], single.hero_xy)
  assert_states_match(jax_state_to_numpy(jstates),
                      ttypes.scene_state_to_numpy(tstates), atol=0.0)
  actions = np.asarray([[0.7, 0.05, 0.0], [0.2, -0.3, 0.0],
                        [0.0, 0.0, 0.5]], np.float32)
  jnext = jsim.world.batched_world_step(jp, jstates, jnp.asarray(actions))
  tnext = tworld.batched_world_step(tp, tstates, torch.from_numpy(actions))
  assert_states_match(jax_state_to_numpy(jnext),
                      ttypes.scene_state_to_numpy(tnext), atol=ATOL)
  np.testing.assert_allclose(
      tsynth.hero_yaw_deg(tnext).numpy(),
      np.asarray(jax.vmap(jsynth.hero_yaw_deg)(jnext)), atol=1e-3)


def test_pid_state_zero_matches():
  want = jtypes.PIDState.zero()
  got = ttypes.PIDState.zero()
  for name in ("err_buf", "prev_error"):
    w, g = np.asarray(getattr(want, name)), getattr(got, name).numpy()
    assert g.shape == w.shape and g.dtype == w.dtype, name
    np.testing.assert_array_equal(g, w)


def test_build_grid_town_matches():
  xs, ys = JAX_GRIDS["Town02"]
  assert TORCH_GRIDS["Town02"] == (xs, ys)
  want = jbuilder.build_grid_town("Town02", xs, ys)
  got = tbuilder.build_grid_town("Town02", xs, ys)
  for name in ("wp_xy", "wp_yaw", "wp_next", "spawn_wp", "nearest_wp",
               "road_mask", "wall_rects", "road_rects"):
    np.testing.assert_array_equal(getattr(got, name), getattr(want, name),
                                  err_msg=name)
