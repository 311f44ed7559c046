"""The staged RIP policy (``baselines/learned/rip/policy.RipPolicy``) on the
CPU at the published widths (K = 4 DIM members, seeded weights from
``perfbench/weights.draw``): against the benchmark's plain reference
(``perfbench/reference/policy/rip_policy.py``) in the closed loop, its
stages against ``rip_plan``, its device marks, and the benchmark's RIP
rollout harness (``perfbench/drivers/rip_rollout.py``) at a small size,
sound and with planted faults."""

import time

import pytest
import torch

from oatomobile_torch.baselines.learned.rip import policy as rip_policy
from oatomobile_torch.baselines.learned.rip.agent import rip_plan
from oatomobile_torch.envs.batched import BatchedEnv
from oatomobile_torch.models import ImitativeModel
from oatomobile_torch.utils import profiling
from perfbench import registry
from perfbench import weights as weights_lib
from perfbench.check import failed
from perfbench.drivers import rip_rollout
from perfbench.reference import rollout as ref_rollout
from perfbench.reference.models.dim import ImitativeModel as RefModel
from perfbench.reference.policy.rip_policy import RipPolicy as RefRipPolicy

torch.set_num_threads(1)

K = 4
PLAN_STEPS = 10
SEED = 2**31 + 19
SCENES = 3
ENV_KWARGS = dict(num_vehicles=4, max_episode_steps=1500,
                  route_capacity=512, seed=7)
CELL = "rip-wcm-k4-town01-b1024"


@pytest.fixture(scope="module")
def weights():
  shape = RefModel(device="meta")
  return [weights_lib.draw(shape, rip_rollout.member_seed(SEED, k, K), "cpu")
          for k in range(K)]


def _program(weights, **kwargs):
  return rip_policy.make_rip_policy(
      [weights_lib.load(ImitativeModel(device="meta"), w, "cpu")
       for w in weights], **kwargs)


def _reference(weights, **kwargs):
  return RefRipPolicy([weights_lib.load(RefModel(device="meta"), w, "cpu")
                       for w in weights], **kwargs)


@pytest.mark.parametrize("algorithm", ("WCM", "MA", "BCM"))
def test_the_staged_policy_equals_the_reference_in_the_closed_loop(
    weights, algorithm):
  """Two closed-loop steps from the same scenes.  Tolerance: none.  Both
  run the same float32 operations in the same order on the same device
  (the reference is a frozen copy of the models, the Adam loop written
  out), so every leaf of the state and every stat is equal bit for bit;
  the bridge switches between throttle and brake on a plan's last bits,
  so any tolerance here would hide a real difference."""
  env = BatchedEnv("Town02", SCENES, device="cpu", **ENV_KWARGS)
  ref = ref_rollout.ReferenceEnv("Town02", SCENES, device="cpu",
                                 **ENV_KWARGS)
  start = ref_rollout.leaves(env.state)
  initial = ref_rollout.leaves(ref.initial)
  assert all(torch.equal(v, initial[k]) for k, v in start.items())
  final, _, stats = env.rollout(2, policy=_program(weights,
                                                   algorithm=algorithm))
  want_state, want_stats = ref.rollout(
      ref_rollout.state_from_leaves(start), 2,
      _reference(weights, algorithm=algorithm))
  got = ref_rollout.leaves(final)
  want = ref_rollout.leaves(want_state)
  assert set(got) == set(want)
  for k in want:
    assert torch.equal(got[k], want[k]), k
  for k in want_stats:
    assert torch.equal(stats[k], want_stats[k]), k
  assert bool((stats["distance"] > 0).any())


def test_encode_then_plan_equals_rip_plan(weights):
  """Bit for bit: the stages are ``rip_plan`` cut in two."""
  env = BatchedEnv("Town02", SCENES, device="cpu", **ENV_KWARGS)
  policy = _program(weights)
  obs = policy.observe(env.params, env.state)
  z = policy.encode(obs)
  assert z.shape == (K, SCENES, 64) and z.dtype == torch.float32
  staged = policy.plan(z, obs)
  with torch.no_grad():
    whole = rip_plan(policy.ensemble, obs.goal, obs.context,
                     num_steps=PLAN_STEPS, lr=0.1, epsilon=1.0)
  assert torch.equal(staged, whole)
  assert not any(p.requires_grad or p.grad is not None
                 for p in policy.ensemble.parameters())


def test_a_call_marks_its_stages_with_their_counts(weights):
  env = BatchedEnv("Town02", SCENES, device="cpu", **ENV_KWARGS)
  policy = _program(weights)
  profiling.reset()
  try:
    env.rollout(1, policy=policy)
    snap = profiling.snapshot()
  finally:
    profiling.reset()
  counts = {"rip.observe": 1, "rip.encode": K,
            "rip.plan": K * PLAN_STEPS, "rip.act": 1}
  for name, count in counts.items():
    (sample,) = snap[name]["samples"]
    assert sample.count == count and sample.parent == "step", name
    assert sample.ms > 0.0


SMALL = {"scenes": 3, "check_within": 2}
RUN_SEED = 2**31 + 101


def _cell():
  cell = registry.cell(CELL, registry.benchmark())
  return cell, dict(cell["traffic"], **SMALL)


def test_rip_rollout_reads_correct_on_a_sound_run():
  cell, _ = _cell()
  result = rip_rollout.run(cell, seed=RUN_SEED, seconds=0.2, trace=False,
                           control=False, device="cpu",
                           process_start=time.perf_counter(),
                           overrides=SMALL)
  assert {c.name: c.value for c in result.checks} == {
      "init_mismatch": 0, "state_gap": 0.0}
  assert failed(result.checks) == 0
  assert result.end_to_end["env_steps_per_s"] > 0


def _checks_past_the_warm_up():
  """The rollout harness's check (``rip_rollout.compare``) of one chunk of the
  program on the cell's scene batch at a small size, with every scene's
  step counter first set to 150.  Before step 100 the plan moves nothing
  here: the bridge's warm-up floor sets the speed, and a plan shorter than
  2 m (as the seeded members make) hands its setpoint to the route.  Past
  it, the plan sets each scene's target speed."""
  cell, traffic = _cell()
  config = cell["config"]
  weights = rip_rollout._weights(config, RUN_SEED, "cpu")  # pylint: disable=protected-access
  env = BatchedEnv(traffic["town"], int(traffic["scenes"]),
                   num_vehicles=traffic["vehicles"],
                   max_episode_steps=traffic["max_episode_steps"],
                   route_capacity=traffic["route_capacity"],
                   seed=rip_rollout.env_seed(RUN_SEED), device="cpu")
  initial = ref_rollout.leaves(env.state)
  env._state.step.fill_(150)  # pylint: disable=protected-access
  before = env.state
  policy = rip_rollout._policy(config, weights, "cpu", reference=False)  # pylint: disable=protected-access
  after, _, stats = env.rollout(int(traffic["chunk_steps"]), policy=policy)
  kept = {0: (ref_rollout.leaves(before), ref_rollout.leaves(after), stats)}
  return rip_rollout.compare(config, traffic, RUN_SEED, weights, initial,
                             kept, False, "cpu")


def test_the_check_past_the_warm_up_is_correct():
  checks = _checks_past_the_warm_up()
  assert {c.name: c.value for c in checks} == {"init_mismatch": 0,
                                               "state_gap": 0.0}


def _wcm_as_ma(monkeypatch):
  plan = rip_policy.rip_plan_from_z
  monkeypatch.setattr(rip_policy, "rip_plan_from_z",
                      lambda *a, **kw: plan(*a, **dict(kw, algorithm="MA")))


def _member_zero_z(monkeypatch):
  encode = rip_policy.rip_encode

  def broken(encoders, context):
    z = encode(encoders, context)
    return z[:1].expand_as(z).contiguous()

  monkeypatch.setattr(rip_policy, "rip_encode", broken)


def _nine_plan_steps(monkeypatch):
  plan = rip_policy.rip_plan_from_z
  monkeypatch.setattr(rip_policy, "rip_plan_from_z",
                      lambda *a, **kw: plan(*a, **dict(kw, num_steps=9)))


@pytest.mark.parametrize("fault", [_wcm_as_ma, _member_zero_z,
                                   _nine_plan_steps])
def test_a_planted_fault_is_not_correct(monkeypatch, fault):
  fault(monkeypatch)
  assert failed(_checks_past_the_warm_up()) > 0
