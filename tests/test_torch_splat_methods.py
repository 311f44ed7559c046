"""The port's interval and blocked splat methods (``ops/bev.py``) against
the JAX package's methods of the same name on the CPU: the per-(row, rect)
column intervals, the two occupancy tests, and ``splat_lidar(method=...)``
for each of ``"dense"``, ``"interval"`` and ``"blocked"``.

Tolerances: interval centres and half-widths within 1e-3 column units
(the two libraries round the linear forms differently; XLA contracts them
into FMAs), except where a rect's slope is within rounding of the 1e-6
degenerate threshold (none in these scenes); occupancy and the splat's
pixels as ``tests/test_torch_bev.py`` holds them: values within 1e-6, and
under 1e-4 of the pixels may fall the other side of a rect edge.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oatomobile_torch.ops import bev as tbev
from oatomobile_tpu.ops import bev as jbev
from test_torch_bev import CASES, EDGE_FRACTION, VALUE_ATOL, _scenes
from torch_port_helpers import fraction_beyond

torch.set_num_threads(1)

INTERVAL_ATOL = 1e-3


@pytest.fixture(scope="module", params=CASES,
                ids=lambda c: "{}-{}v-{}p-{}s".format(*c[:4]))
def scenes(request):
  return _scenes(*request.param)


def _walls(jp, states, tp, ts):
  """Each scene's selected walls, as both packages select them."""
  k = min(tbev.MAX_BEV_WALLS, tp.wall_budget)
  got = tbev.nearest_rects(tp.map["wall_rects"], ts.hero_xy, k,
                           max_range=tbev.METERS_MAX * 1.04)
  want = jax.vmap(lambda s: jbev.nearest_rects(
      jp.map["wall_rects"], s.hero_xy, k,
      max_range=jbev.METERS_MAX * 1.04))(states)
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))
  return want, got


def test_rect_column_intervals_match(scenes):
  jp, states, tp, ts = scenes
  jw, tw = _walls(jp, states, tp, ts)
  mid, half = tbev.rect_column_intervals(
      tw, ts.hero_xy, torch.cos(ts.hero_yaw), torch.sin(ts.hero_yaw),
      inflate=0.5)
  jmid, jhalf = jax.vmap(lambda r, s: jbev.rect_column_intervals(
      r, s.hero_xy, jnp.cos(s.hero_yaw), jnp.sin(s.hero_yaw),
      inflate=0.5))(jw, states)
  jmid, jhalf = np.asarray(jmid), np.asarray(jhalf)
  assert mid.shape == jmid.shape == (3, tbev.BEV_SIZE, tw.shape[1])
  # Empty intervals are (+-1e9 sums): compare their emptiness.
  empty = jhalf < 0
  np.testing.assert_array_equal(half.numpy() < 0, empty)
  np.testing.assert_allclose(mid.numpy()[~empty], jmid[~empty],
                             atol=INTERVAL_ATOL)
  np.testing.assert_allclose(half.numpy()[~empty], jhalf[~empty],
                             atol=INTERVAL_ATOL)


@pytest.mark.parametrize("blocked", [False, True], ids=["plain", "blocked"])
def test_intervals_occupancy_matches(scenes, blocked):
  """Both occupancy tests on the same (JAX) intervals: equal bit for bit
  (compares and a selection, no rounding)."""
  jp, states, _, _ = scenes
  walls = jax.vmap(lambda s: jbev.nearest_rects(
      jp.map["wall_rects"], s.hero_xy,
      min(jbev.MAX_BEV_WALLS, jp.wall_budget)))(states)
  jmid, jhalf = jax.vmap(lambda r, s: jbev.rect_column_intervals(
      r, s.hero_xy, jnp.cos(s.hero_yaw), jnp.sin(s.hero_yaw)))(walls, states)
  if blocked:
    want = jax.vmap(jbev.intervals_occupancy_blocked)(jmid, jhalf)
    got = tbev.intervals_occupancy_blocked(torch.as_tensor(np.asarray(jmid)),
                                           torch.as_tensor(np.asarray(jhalf)))
  else:
    want = jax.vmap(jbev.intervals_occupancy)(jmid, jhalf)
    got = tbev.intervals_occupancy(torch.as_tensor(np.asarray(jmid)),
                                   torch.as_tensor(np.asarray(jhalf)))
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))
  assert got.any()


def test_blocked_budget_drops_the_narrowest():
  """Beyond the budget a block keeps its widest intervals (ties to the
  lower index, as ``lax.top_k``), as the JAX function does."""
  rs = np.random.RandomState(3)
  mid = rs.uniform(-40, 40, (2, 200, 20)).astype(np.float32)
  half = rs.uniform(-2, 6, (2, 200, 20)).astype(np.float32)
  half[:, :, 5] = half[:, :, 6]  # a tie
  want = jax.vmap(lambda m, h: jbev.intervals_occupancy_blocked(
      m, h, budget=4))(mid, half)
  got = tbev.intervals_occupancy_blocked(torch.as_tensor(mid),
                                         torch.as_tensor(half), budget=4)
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_rects_occupancy_interval_matches(scenes):
  jp, states, tp, ts = scenes
  k = min(tbev.MAX_BEV_ROADS, tp.road_budget)
  roads = tbev.nearest_rects(tp.map["road_rects"], ts.hero_xy, k)
  jroads = jax.vmap(lambda s: jbev.nearest_rects(
      jp.map["road_rects"], s.hero_xy, k))(states)
  got = tbev.rects_occupancy_interval(roads, ts.hero_xy, ts.hero_yaw,
                                      inflate=tbev.SIDEWALK)
  want = jax.vmap(lambda r, s: jbev.rects_occupancy_interval(
      r, s.hero_xy, s.hero_yaw, inflate=jbev._SIDEWALK))(jroads, states)  # pylint: disable=protected-access
  assert got.shape == (3, 200, 200)
  assert (got.numpy() != np.asarray(want)).mean() < EDGE_FRACTION


@pytest.mark.parametrize("method", ["dense", "interval", "blocked"])
def test_splat_lidar_method_matches_jax(scenes, method):
  jp, states, tp, ts = scenes
  want = np.asarray(jax.vmap(lambda s: jbev.splat_lidar(
      jp, s, method=method))(states))
  got = tbev.splat_lidar(tp, ts, method=method).numpy()
  assert got.shape == want.shape == (3, 200, 200, 2)
  assert got.dtype == np.float32
  assert fraction_beyond(got, want, VALUE_ATOL) < EDGE_FRACTION
  # The methods agree with each other as closely.
  dense = tbev.splat_lidar(tp, ts).numpy()
  assert fraction_beyond(got, dense, VALUE_ATOL) < EDGE_FRACTION


def test_splat_lidar_rejects_an_unknown_method(scenes):
  _, _, tp, ts = scenes
  with pytest.raises(ValueError):
    tbev.splat_lidar(tp, ts, method="sparse")
