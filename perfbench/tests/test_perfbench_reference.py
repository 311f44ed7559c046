"""The plain reference against the program at a tiny size on the CPU:
the draws, the town and its routes, the scene batch, the autopilot
rollout with the LIDAR and the DIM policy's closed loop."""

import numpy as np
import pytest
import torch

from perfbench import weights
from perfbench.reference import rollout as ref_rollout
from perfbench.reference import threefry
from perfbench.reference.maps import towns as ref_towns

SEED = 2**31 + 5


def test_threefry_known_answer():
  # Random123's known-answer vector for Threefry-2x32, 20 rounds.
  key0, key1 = torch.tensor([0x13198A2E]), torch.tensor([0x03707344])
  a, b = threefry._hash(key0, key1, torch.tensor([0x243F6A88]),  # pylint: disable=protected-access
                        torch.tensor([0x85A308D3]))
  assert (int(a), int(b)) == (0xC4923A9C, 0x483DF7A0)


def test_threefry_draws_match_the_program():
  from oatomobile_torch import rng  # pylint: disable=import-outside-toplevel
  keys = rng.PRNGKey(np.arange(6) * 7919 + SEED)
  assert torch.equal(rng.split(keys, 3), threefry.split(keys, 3))
  assert torch.equal(rng.fold_in(keys, 11), threefry.fold_in(keys, 11))
  assert torch.equal(rng.uniform(keys, (9,), -1.0, 1.0),
                     threefry.uniform(keys, (9,), -1.0, 1.0))
  assert torch.equal(rng.normal(keys, (9,)), threefry.normal(keys, (9,)))


def test_town_matches_the_program():
  from oatomobile_torch.maps import load_town  # pylint: disable=import-outside-toplevel
  got, want = load_town("Town01"), ref_towns.load_town("Town01")
  for name, value in vars(want).items():
    if isinstance(value, np.ndarray):
      assert np.array_equal(getattr(got, name), value), name


@pytest.fixture(scope="module")
def envs():
  from oatomobile_torch.envs.batched import BatchedEnv  # pylint: disable=import-outside-toplevel
  kwargs = dict(num_vehicles=16, route_capacity=1024, seed=SEED,
                device="cpu")
  return (BatchedEnv("Town01", 3, **kwargs),
          ref_rollout.ReferenceEnv("Town01", 3, **kwargs))


def _same(got, want):
  for name, value in want.items():
    assert torch.equal(got[name], value), name


def test_scene_batch_matches_the_program(envs):
  env, ref = envs
  _same(ref_rollout.leaves(env.state), ref_rollout.leaves(ref.initial))


def test_autopilot_rollout_with_lidar_matches_the_program(envs):
  env, ref = envs
  start = env.state
  final, _, stats = env.rollout(5, compute=("lidar",))
  want, want_stats = ref.rollout(
      ref_rollout.state_from_leaves(ref_rollout.leaves(start)), 5,
      compute=("lidar",))
  _same(ref_rollout.leaves(final), ref_rollout.leaves(want))
  _same(stats, want_stats)


def test_dim_closed_loop_matches_the_program(envs):
  from oatomobile_torch.baselines.learned.dim.policy import make_dim_policy  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.models import ImitativeModel  # pylint: disable=import-outside-toplevel
  from perfbench.reference.models.dim import ImitativeModel as RefModel  # pylint: disable=import-outside-toplevel
  from perfbench.reference.policy.dim_policy import DimPolicy  # pylint: disable=import-outside-toplevel
  env, ref = envs
  w = weights.draw(RefModel((4, 2), (100, 100), device="meta"), SEED, "cpu")
  program = make_dim_policy(weights.load(
      ImitativeModel((4, 2), (100, 100), device="meta"), w, "cpu"))
  reference = DimPolicy(weights.load(
      RefModel((4, 2), (100, 100), device="meta"), w, "cpu"))
  start = env.state
  final, _, stats = env.rollout(2, policy=program)
  want, want_stats = ref.rollout(
      ref_rollout.state_from_leaves(ref_rollout.leaves(start)), 2, reference)
  _same(ref_rollout.leaves(final), ref_rollout.leaves(want))
  _same(stats, want_stats)


def test_weights_are_the_seeds():
  from perfbench.reference.models.dim import ImitativeModel as RefModel  # pylint: disable=import-outside-toplevel
  shape = RefModel((4, 2), (100, 100), device="meta")
  a, b = (weights.draw(shape, SEED, "cpu") for _ in range(2))
  c = weights.draw(shape, SEED + 1, "cpu")
  assert all(torch.equal(a[k], b[k]) for k in a)
  assert any(not torch.equal(a[k], c[k]) for k in a)
