"""oatomobile_torch.models against oatomobile_tpu.models on the CPU.

Weights are seeded numpy draws laid out as the flax tree of each JAX
module (its shapes from ``jax.eval_shape`` of ``init``), carried into the
port by ``oatomobile_torch.models.convert``; inputs are seeded numpy
arrays.  Both libraries compute in float32 with their own GEMMs and
convolutions, so outputs agree to float32 rounding accumulated over the
network's depth; each test states its tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from oatomobile_torch import models as tmodels
from oatomobile_torch.models import convert
from oatomobile_torch.models import dim as tdim
from oatomobile_torch.models import initializers
from oatomobile_torch.models import transforms as ttransforms
from oatomobile_tpu import models as jmodels
from oatomobile_tpu.models import transforms as jtransforms

torch.set_num_threads(1)

# Leaves and parameters of the JAX ImitativeModel((4, 2), (100, 100)).
DIM_LEAVES, DIM_PARAMS = 178, 2_419_588


def random_tree(module, *args, seed=0, **kwargs):
  """A flax parameter tree of ``module`` (shapes from ``init(*args)``) with
  seeded numpy values: kernels N(0, 1/fan_in), GroupNorm scales near 1,
  small nonzero biases (so that a swapped or dropped bias shows)."""
  shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args,
                                              **kwargs))
  rs = np.random.RandomState(seed)

  def draw(path, leaf):
    name = path[-1].key
    if name == "kernel":
      fan_in = int(np.prod(leaf.shape[:-1]))
      return (rs.standard_normal(leaf.shape) /
              np.sqrt(fan_in)).astype(np.float32)
    if name == "scale":
      return (1.0 + 0.1 * rs.standard_normal(leaf.shape)).astype(np.float32)
    return (0.1 * rs.standard_normal(leaf.shape)).astype(np.float32)

  return jax.tree_util.tree_map_with_path(draw, shapes)


def dim_context(batch, seed, size=100):
  rs = np.random.RandomState(seed)
  return dict(
      visual_features=rs.uniform(size=(batch, size, size, 2)).astype(
          np.float32),
      velocity=rs.uniform(-3, 3, size=(batch, 3)).astype(np.float32),
      is_at_traffic_light=rs.randint(0, 2, (batch, 1)).astype(np.float32),
      traffic_light_state=rs.randint(0, 3, (batch, 1)).astype(np.float32))


def to_torch_context(ctx):
  """numpy NHWC context -> the port's tensors (NCHW visual features)."""
  out = {k: torch.from_numpy(v) for k, v in ctx.items()}
  out["visual_features"] = out["visual_features"].permute(0, 3, 1, 2)
  return out


def scaled_err(got, want):
  """max |got - want| / max(max |want|, 1)."""
  want = np.asarray(want)
  return (float(np.abs(np.asarray(got) - want).max()) /
          max(float(np.abs(want).max()), 1.0))


@pytest.fixture(scope="module")
def dim_models():
  jm = jmodels.ImitativeModel((4, 2), (100, 100))
  tree = random_tree(jm, jnp.zeros((1, 4, 2)), method=jm.log_prob,
                     **{k: jnp.zeros(v.shape[:0] + (1,) + v.shape[1:])
                        for k, v in dim_context(1, 0).items()})
  tm = convert.load(tmodels.ImitativeModel((4, 2), (100, 100), device="cpu"),
                    tree)
  return jm, tree, tm


# -- building blocks ------------------------------------------------------------


def test_mlp_matches():
  jm = jmodels.MLP((64, 32, 8), activate_final=True)
  tree = random_tree(jm, jnp.zeros((1, 133)))
  tm = convert.load(tmodels.MLP(133, (64, 32, 8), activate_final=True,
                                device="cpu"), tree)
  x = np.random.RandomState(1).standard_normal((5, 133)).astype(np.float32)
  want = np.asarray(jm.apply(tree, x))
  got = tm(torch.from_numpy(x)).detach().numpy()
  # Three float32 GEMMs of width <= 133: 1e-5 of values of O(1).
  np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
  assert (got >= 0).all()


def test_resize_and_transpose_match():
  rs = np.random.RandomState(2)
  images = rs.uniform(size=(2, 200, 200, 2)).astype(np.float32)
  want = np.asarray(jtransforms.downsample_visual_features(images,
                                                           (100, 100)))
  nchw = torch.from_numpy(images).permute(0, 3, 1, 2)
  got = ttransforms.downsample_visual_features(nchw, (100, 100))
  # Antialiased bilinear 200 -> 100 (a 4-tap filter per axis): 1e-6.
  np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0,
                             atol=1e-6)
  # The transpose is an exact move: the NCHW swap of H and W is the JAX
  # package's NHWC swap.
  got_t = ttransforms.transpose_visual_features(got)
  np.testing.assert_array_equal(
      got_t.permute(0, 2, 3, 1).numpy(),
      np.asarray(jtransforms.transpose_visual_features(
          got.permute(0, 2, 3, 1).numpy())))
  prepared = ttransforms.prepare_visual_features(torch.from_numpy(images),
                                                 (100, 100))
  np.testing.assert_array_equal(prepared.numpy(), got_t.numpy())


def test_downsample_target_matches():
  future = np.random.RandomState(3).standard_normal((2, 80, 2)).astype(
      np.float32)
  want = np.asarray(jtransforms.downsample_target(future, 4))
  got = ttransforms.downsample_target(torch.from_numpy(future), 4).numpy()
  np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size,pads", [(100, [(0, 1), (0, 1), (1, 1),
                                              (1, 1), (1, 1)]),
                                       (50, [(0, 1), (1, 1), (1, 1),
                                             (1, 1), (0, 1)])])
def test_same_padding_follows_flax(size, pads):
  # The five stride-2 3x3 convs of MobileNetV2 (stem and four blocks).
  from oatomobile_torch.models.perception import same_padding
  got = []
  for _ in range(5):
    got.append(same_padding(size, 3, 2))
    size = -(-size // 2)
  assert got == pads
  assert same_padding(13, 3, 1) == (1, 1)


def test_mobilenet_v2_features_match():
  jm = jmodels.MobileNetV2(num_classes=128)
  tree = random_tree(jm, jnp.zeros((1, 100, 100, 2)))
  tm = convert.load(tmodels.MobileNetV2(2, 128, device="cpu"), tree)
  x = np.random.RandomState(4).uniform(size=(2, 100, 100, 2)).astype(
      np.float32)
  want = np.asarray(jm.apply(tree, x))
  got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).detach().numpy()
  assert got.shape == want.shape == (2, 128)
  # 53 convs and GroupNorms in float32; GroupNorm's variance is E[x^2] -
  # E[x]^2 in flax and two-pass in torch: 1e-4 of the largest feature.
  print("mobilenet_v2 scaled error", scaled_err(got, want))
  assert scaled_err(got, want) < 1e-4


def test_flow_forward_inverse_and_log_prob_match():
  jf = jmodels.AutoregressiveFlow(output_shape=(4, 2))
  tree = random_tree(jf, jnp.zeros((1, 64)), jax.random.PRNGKey(0))
  tf = convert.load(tmodels.AutoregressiveFlow((4, 2), device="cpu"), tree)
  rs = np.random.RandomState(5)
  z = rs.standard_normal((3, 64)).astype(np.float32)
  x = rs.standard_normal((3, 4, 2)).astype(np.float32)
  y_j, ld_j = jf.apply(tree, x, z, method=jf._forward)  # pylint: disable=protected-access
  y_t, ld_t = tf._forward(torch.from_numpy(x), torch.from_numpy(z))  # pylint: disable=protected-access
  # Four GRU steps of width 64 in float32: 1e-5.
  np.testing.assert_allclose(y_t.detach().numpy(), y_j, rtol=0, atol=1e-5)
  np.testing.assert_allclose(ld_t.detach().numpy(), ld_j, rtol=0, atol=1e-5)
  xr_j, lp_j, ldi_j = jf.apply(tree, y_j, z, method=jf._inverse)  # pylint: disable=protected-access
  xr_t, lp_t, ldi_t = tf._inverse(torch.from_numpy(np.array(y_j)),  # pylint: disable=protected-access
                                  torch.from_numpy(z))
  np.testing.assert_allclose(xr_t.detach().numpy(), xr_j, rtol=0, atol=1e-5)
  np.testing.assert_allclose(lp_t.detach().numpy(), lp_j, rtol=0, atol=1e-5)
  np.testing.assert_allclose(ldi_t.detach().numpy(), ldi_j, rtol=0,
                             atol=1e-5)


def test_flow_sample_uses_the_generator():
  tf = tmodels.AutoregressiveFlow((4, 2), device="cpu")
  z = torch.zeros(3, 64)
  a = tf(z, torch.Generator().manual_seed(7))
  b = tf(z, torch.Generator().manual_seed(7))
  c = tf(z, torch.Generator().manual_seed(8))
  assert a.shape == (3, 4, 2) and torch.equal(a, b)
  assert not torch.equal(a, c)


def test_goal_likelihood_matches():
  rs = np.random.RandomState(6)
  y = rs.standard_normal((3, 4, 2)).astype(np.float32)
  goal = rs.standard_normal((3, 10, 2)).astype(np.float32) * 4
  for eps in (1.0, 0.5):
    want = np.asarray(jmodels.ImitativeModel.goal_likelihood(y, goal, eps))
    got = tdim.goal_likelihood(torch.from_numpy(y), torch.from_numpy(goal),
                               eps).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# -- DIM and CIL ------------------------------------------------------------------


def test_converter_uses_every_leaf_once(dim_models):
  _, tree, tm = dim_models
  assert convert.count_leaves(tree) == DIM_LEAVES
  assert sum(np.size(l) for l in jax.tree.leaves(tree)) == DIM_PARAMS
  sd = convert.state_dict(tree)
  assert set(sd) == set(tm.state_dict())
  # The port's GRU holds exactly flax's parameters.
  assert sum(v.numel() for v in sd.values()) == DIM_PARAMS
  for key, value in sd.items():
    assert torch.equal(tm.state_dict()[key], value), key
  gru = tree["params"]["decoder"]["gru"]
  np.testing.assert_array_equal(sd["decoder.gru.weight_hh"][128:].numpy(),
                                gru["hn"]["kernel"].T)
  np.testing.assert_array_equal(sd["decoder.gru.bias_ih"][:64].numpy(),
                                gru["ir"]["bias"])
  np.testing.assert_array_equal(sd["decoder.gru.bias_hn"].numpy(),
                                gru["hn"]["bias"])
  assert not tm.decoder.gru.bias_hh[:128].any()
  np.testing.assert_array_equal(
      sd["encoder.block_1.depthwise.weight"].numpy(),
      tree["params"]["encoder"]["block_1"]["depthwise"]["kernel"].transpose(
          3, 2, 0, 1))
  # A leaf the port does not know, or a missing one, is refused.
  extra = jax.tree.map(lambda x: x, tree)
  extra["params"]["merger"]["dense_0"]["extra"] = np.zeros(3, np.float32)
  with pytest.raises(ValueError):
    convert.state_dict(extra)
  missing = jax.tree.map(lambda x: x, tree)
  del missing["params"]["merger"]["dense_2"]
  with pytest.raises(RuntimeError):
    convert.load(tmodels.ImitativeModel(device="cpu"), missing)


def test_params_z_and_log_prob_match(dim_models):
  jm, tree, tm = dim_models
  ctx = dim_context(2, 7)
  want = np.asarray(jm.apply(tree, method=jm.params_z, **ctx))
  got = tm.params_z(**to_torch_context(ctx)).detach().numpy()
  # The acceptance bound of converted weights: 1e-4 of max(|z|max, 1).
  print("params_z scaled error", scaled_err(got, want))
  assert scaled_err(got, want) < 1e-4
  y = np.random.RandomState(8).standard_normal((2, 4, 2)).astype(np.float32)
  lp_j = np.asarray(jm.apply(tree, y, method=jm.log_prob, **ctx))
  lp_t = tm.log_prob(torch.from_numpy(y), **to_torch_context(ctx))
  assert scaled_err(lp_t.detach().numpy(), lp_j) < 1e-4


PLAN_GOALS = np.stack([np.tile([[6.0, 2.0]], (10, 1)),
                       np.tile([[-3.0, -5.0]], (10, 1))]).astype(np.float32)


def test_plan_from_z_matches(dim_models):
  jm, tree, tm = dim_models
  z = (np.random.RandomState(9).standard_normal((2, 64)) * 0.5).astype(
      np.float32)
  kwargs = dict(num_steps=5, lr=0.1, epsilon=0.5)
  zt, goal_t = torch.from_numpy(z), torch.from_numpy(PLAN_GOALS)
  # Adam's first step is lr * sign(g): every component of the first
  # gradient must be clear of 0, or float32 rounding could flip a sign.
  x0 = torch.zeros(2, 4, 2, requires_grad=True)
  y0 = tm.decode(x0, zt)
  loss = -(tm.imitation_prior_from_z(y0, zt) +
           tdim.goal_likelihood(y0, goal_t, 0.5))
  (g,) = torch.autograd.grad(loss.sum(), x0)
  assert float(g.abs().min()) > 1e-3, g
  want = np.asarray(jm.apply(tree, z, goal=PLAN_GOALS, **kwargs,
                             method=jm.plan_from_z))
  with torch.no_grad():
    got = tm.plan_from_z(zt, goal=goal_t, **kwargs).numpy()
  # Five Adam steps through the flow's forward and inverse: 1e-4 m.
  print("plan_from_z max abs error", float(np.abs(got - want).max()))
  np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
  assert np.abs(got[0] - got[1]).max() > 0.5
  assert not any(p.grad is not None for p in tm.parameters())


def test_plan_matches_plan_from_z(dim_models):
  _, _, tm = dim_models
  ctx = to_torch_context(dim_context(2, 10))
  goal = torch.from_numpy(PLAN_GOALS)
  with torch.no_grad():
    a = tm.plan(num_steps=3, goal=goal, **ctx)
    b = tm.plan_from_z(tm.params_z(**ctx), num_steps=3, goal=goal)
  assert torch.equal(a, b)
  with pytest.raises(ValueError):
    tm.params_z(velocity=ctx["velocity"])


def test_adam_update_matches_optax():
  rs = np.random.RandomState(11)
  x = rs.standard_normal((3, 4, 2)).astype(np.float32)
  opt = optax.adam(5e-2)
  state = opt.init(jnp.asarray(x))
  xt = torch.from_numpy(x)
  mu, nu = torch.zeros_like(xt), torch.zeros_like(xt)
  xj = jnp.asarray(x)
  for count in range(1, 4):
    g = rs.standard_normal((3, 4, 2)).astype(np.float32)
    updates, state = opt.update(jnp.asarray(g), state, xj)
    xj = optax.apply_updates(xj, updates)
    update, mu, nu = tdim.adam_update(torch.from_numpy(g), mu, nu, count,
                                      5e-2)
    xt = xt + update
    # float32 rounding of the bias corrections and the square root.
    np.testing.assert_allclose(update.numpy(), np.asarray(updates), rtol=0,
                               atol=1e-7)
    np.testing.assert_allclose(mu.numpy(), np.asarray(state[0].mu), rtol=0,
                               atol=1e-7)
    np.testing.assert_allclose(nu.numpy(), np.asarray(state[0].nu), rtol=0,
                               atol=1e-7)
  np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0, atol=1e-6)


def test_dim_transform_matches(dim_models):
  jm, _, tm = dim_models
  rs = np.random.RandomState(12)
  sample = {"player_future": rs.standard_normal((2, 80, 2)).astype(
                np.float32),
            "lidar": rs.uniform(size=(2, 200, 200, 2)).astype(np.float32)}
  want = jm.transform(sample)
  got = tm.transform({k: torch.from_numpy(v) for k, v in sample.items()})
  assert "lidar" not in got
  np.testing.assert_array_equal(got["player_future"].numpy(),
                                want["player_future"])
  np.testing.assert_allclose(
      got["visual_features"].permute(0, 2, 3, 1).numpy(),
      want["visual_features"], rtol=0, atol=1e-6)


def test_bf16_encoder_tracks_f32(dim_models):
  _, _, tm = dim_models
  from oatomobile_torch.baselines.learned.dim.policy import (encode,
                                                              encoder_copy)
  ctx = to_torch_context(dim_context(2, 13))
  z = encode(tm, ctx)
  z16 = encode(encoder_copy(tm, "bfloat16"), ctx)
  assert z16.dtype == torch.float32
  assert next(encoder_copy(tm, "bfloat16").parameters()).dtype == (
      torch.bfloat16)
  # The JAX package's bound (tests/test_models.py).
  err = float((z16 - z).abs().max())
  assert err < 0.05 * max(float(z.abs().max()), 1.0), err


def test_cil_plan_and_transform_match():
  jm = jmodels.BehaviouralModel()
  ctx = dict(dim_context(2, 14), mode=np.asarray([[0.0], [2.0]], np.float32))
  tree = random_tree(jm, **{k: jnp.zeros((1,) + v.shape[1:])
                            for k, v in ctx.items()})
  tm = convert.load(tmodels.BehaviouralModel(device="cpu"), tree)
  want = np.asarray(jm.apply(tree, **ctx))
  with torch.no_grad():
    got = tm(**to_torch_context(ctx)).numpy()
  assert got.shape == want.shape == (2, 40, 2)
  # 40 residual GRU steps after the encoder: 1e-4 of the largest value.
  assert scaled_err(got, want) < 1e-4
  modes = np.asarray([[1.0], [2.0]], np.float32)
  np.testing.assert_array_equal(
      tm.transform({"mode": torch.from_numpy(modes)})["mode"].numpy(),
      np.asarray(jm.transform({"mode": modes})["mode"]))


# -- initialisation ----------------------------------------------------------------


def test_flax_like_initialisation():
  g = torch.Generator().manual_seed(3)
  tm = tmodels.ImitativeModel(generator=g, device="cpu")
  again = tmodels.ImitativeModel(generator=torch.Generator().manual_seed(3),
                                 device="cpu")
  for (name, a), b in zip(tm.state_dict().items(),
                          again.state_dict().values()):
    assert torch.equal(a, b), name
  sd = tm.state_dict()
  # lecun_normal: variance 1 / fan_in, truncated at 2 standard deviations.
  head = sd["encoder.head_conv.weight"]  # fan_in 320
  assert abs(float(head.std()) * np.sqrt(320) - 1.0) < 0.02
  assert float(head.abs().max()) <= 2.0 / 0.8796 / np.sqrt(320) + 1e-6
  assert torch.equal(sd["encoder.head_norm.weight"], torch.ones(1280))
  assert not sd["encoder.head_norm.bias"].any()
  assert not sd["merger.dense_0.bias"].any()
  # Orthogonal recurrent kernels, gate by gate.
  hh = sd["decoder.gru.weight_hh"]
  for gate in range(3):
    w = hh[gate * 64:(gate + 1) * 64]
    torch.testing.assert_close(w @ w.T, torch.eye(64), atol=1e-5, rtol=0)
  assert not any(p.is_meta for p in tm.parameters())


def test_truncated_normal_is_bounded_and_unit_variance():
  x = initializers.lecun_normal((200_000,), 1, torch.Generator().manual_seed(0))
  assert float(x.abs().max()) <= 2.0 / 0.87962566103423978 + 1e-6
  assert abs(float(x.std()) - 1.0) < 0.01
