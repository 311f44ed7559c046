"""The port's BatchedEnv against the JAX package's: a closed-loop
autopilot rollout with the BEV LIDAR computed every step, and the
auto-reset key streams."""

import jax.numpy as jnp
import numpy as np
import torch

from oatomobile_torch import rng
from oatomobile_torch.envs.batched import BatchedEnv as TorchBatchedEnv
from oatomobile_torch.ops import bev_cuda
from oatomobile_tpu.envs.batched import BatchedEnv as JaxBatchedEnv

torch.set_num_threads(1)


def test_rollout_with_lidar_matches_jax():
  kwargs = dict(num_vehicles=8, seed=4)
  jenv = JaxBatchedEnv("Town02", 3, **kwargs)
  tenv = TorchBatchedEnv("Town02", 3, device="cpu", **kwargs)
  _, _, want = jenv.rollout(30, compute=("lidar",))
  _, collected, got = tenv.rollout(30, compute=("lidar",))
  assert collected == ()
  want = {k: np.asarray(v) for k, v in want.items()}
  got = {k: v.numpy() for k, v in got.items()}
  for key in want:
    assert got[key].dtype == want[key].dtype, key
  np.testing.assert_array_equal(got["episodes"], want["episodes"])
  np.testing.assert_array_equal(got["collisions"], want["collisions"])
  # 30 steps of float32 dynamics rounded differently by the two libraries
  # (ulp-level per step): metres of travel agree to 1e-3.
  np.testing.assert_allclose(got["distance"], want["distance"], rtol=0,
                             atol=1e-3)
  assert (got["distance"] > 1.0).all()
  # The checksum sums 30 x 80,000 BEV values per scene in different
  # orders, and the JAX sensor uses the interval splat: relative 1e-3.
  np.testing.assert_allclose(got["obs_checksum"], want["obs_checksum"],
                             rtol=1e-3)
  assert (got["obs_checksum"] > 0).all()


def test_rollout_computes_nothing_by_default(monkeypatch):
  # As the JAX package's rollout, ``compute`` defaults to nothing: no
  # lidar synthesis (so no splat), and a zero checksum on both sides.
  calls = []
  splat = bev_cuda.splat_lidar_batch

  def counting_splat(*inputs):
    calls.append(inputs[0].device)
    return splat(*inputs)

  monkeypatch.setattr(bev_cuda, "splat_lidar_batch", counting_splat)
  kwargs = dict(num_vehicles=4, seed=2)
  _, _, want = JaxBatchedEnv("Town02", 2, **kwargs).rollout(5)
  _, _, got = TorchBatchedEnv("Town02", 2, device="cpu", **kwargs).rollout(5)
  assert not np.asarray(want["obs_checksum"]).any()
  assert not got["obs_checksum"].any()
  assert calls == []
  np.testing.assert_array_equal(got["episodes"].numpy(),
                                np.asarray(want["episodes"]))
  np.testing.assert_allclose(got["distance"].numpy(),
                             np.asarray(want["distance"]), rtol=0, atol=1e-4)
  # The same env with ``compute=("lidar",)`` splats once a step.
  TorchBatchedEnv("Town02", 2, device="cpu", **kwargs).rollout(
      5, compute=("lidar",))
  assert calls == [torch.device("cpu")] * 5


def test_rollout_with_policy_collects_as_jax():
  # A caller's open-loop policy and collected observations, stacked over
  # time as [T, B, ...] like the JAX package's.
  action = np.asarray([0.6, 0.2, 0.0], np.float32)

  def jax_policy(params, state):
    del params
    return jnp.tile(jnp.asarray(action), (state.hero_xy.shape[0], 1)), state

  def torch_policy(params, state):
    del params
    return torch.as_tensor(action).expand(state.batch_size, 3), state

  keys = ("location", "speed_limit", "collision")
  kwargs = dict(num_vehicles=4, seed=6)
  _, want, _ = JaxBatchedEnv("Town02", 2, **kwargs).rollout(
      12, policy=jax_policy, collect=keys)
  _, got, _ = TorchBatchedEnv("Town02", 2, device="cpu", **kwargs).rollout(
      12, policy=torch_policy, collect=keys, compute=())
  assert set(got) == set(keys)
  for key in keys:
    w, g = np.asarray(want[key]), got[key].numpy()
    assert g.shape == w.shape and g.shape[:2] == (12, 2), key
    assert g.dtype == w.dtype, key
    # 12 steps of float32 dynamics rounded differently by the two
    # libraries (ulp-level per step) on positions of ~100 m: 1e-4.
    np.testing.assert_allclose(g, w, rtol=0, atol=1e-4, err_msg=key)


def test_auto_reset_rng_streams_chain_as_jax():
  # As tests/test_batched_env.py: episodes that end at a fixed horizon
  # must still get different keys on each reset; and the port's keys are
  # the JAX package's, step for step.
  jenv = JaxBatchedEnv("Town01", batch_size=4, max_episode_steps=10, seed=3)
  tenv = TorchBatchedEnv("Town01", batch_size=4, max_episode_steps=10,
                         seed=3, device="cpu")
  brake = np.tile(np.asarray([0.0, 0.0, 1.0], np.float32), (4, 1))
  seen = []
  for _ in range(25):
    jenv.step(jnp.asarray(brake))
    _, done = tenv.step(brake)
    keys = rng.to_numpy(tenv.state.rng)
    np.testing.assert_array_equal(keys, np.asarray(jenv.state.rng))
    seen.append(keys)
  assert done.dtype == torch.bool and done.shape == (4,)
  keys0 = {tuple(k[0]) for k in seen}
  assert len(keys0) >= 3
