"""oatomobile_torch.rng against jax.random (threefry2x32, partitionable)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oatomobile_torch import rng

torch.set_num_threads(1)

SEEDS = [0, 1, 7, 123, 2**31 - 1, 4_000_000_000]


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_split_bit_exact(seed):
  kj, kt = jax.random.PRNGKey(seed), rng.PRNGKey(seed)
  np.testing.assert_array_equal(rng.to_numpy(kt), np.asarray(kj))
  for num in (2, 3):
    np.testing.assert_array_equal(rng.to_numpy(rng.split(kt, num)),
                                  np.asarray(jax.random.split(kj, num)))


@pytest.mark.parametrize("data", [0, 1, 2, 17, 1499, 2**31 + 5])
def test_fold_in_bit_exact(data):
  keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(5, dtype=jnp.uint32))
  kt = rng.from_numpy(np.asarray(keys))
  want = jax.vmap(lambda k: jax.random.fold_in(k, data))(keys)
  np.testing.assert_array_equal(rng.to_numpy(rng.fold_in(kt, data)),
                                np.asarray(want))
  # Per-key data (the auto-reset folds each scene's step counter).
  steps = np.arange(5, dtype=np.int32) * 37 + data % 1000
  want = jax.vmap(jax.random.fold_in)(keys, jnp.asarray(steps))
  np.testing.assert_array_equal(
      rng.to_numpy(rng.fold_in(kt, torch.as_tensor(steps))), np.asarray(want))


@pytest.mark.parametrize("shape", [(), (1,), (16,), (24,)])
@pytest.mark.parametrize("bounds", [(0.0, 1.0), (-1.0, 1.0), (-3.0, 1.0)])
def test_uniform_bit_exact(shape, bounds):
  # Bounds whose span is a power of two, as at every call site: the
  # scale-and-shift then rounds once whether or not XLA contracts it into
  # an FMA, so the result is bit-exact.
  keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(8, dtype=jnp.uint32) + 3)
  keys = jax.vmap(lambda k: jax.random.split(k, 3)[1])(keys)
  lo, hi = bounds
  want = jax.vmap(lambda k: jax.random.uniform(k, shape, minval=lo,
                                               maxval=hi))(keys)
  got = rng.uniform(rng.from_numpy(np.asarray(keys)), shape, lo, hi)
  assert got.dtype == torch.float32
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", [(), (4,), (512,)])
def test_normal_within_1e6(shape):
  # The uniforms underneath are bit-exact and erfinv follows XLA's
  # polynomial; log1p inside it may differ from XLA's in its last ulp,
  # which moves a sample by at most ~7e-7 over |x| <= 5: tolerance 1e-6.
  keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(64, dtype=jnp.uint32))
  want = jax.vmap(lambda k: jax.random.normal(k, shape))(keys)
  got = rng.normal(rng.from_numpy(np.asarray(keys)), shape)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                             atol=1e-6)
