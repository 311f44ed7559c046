"""TransFuser (``models/transfuser.py``, ``models/resnet.py``) and its
staged policy (``baselines/learned/transfuser``) on the CPU at the
published widths (ResNet-34 and ResNet-18 trunks, four 8-block GPTs),
with seeded weights from the benchmark's ``draw_weights`` and
``calibrate``: against the benchmark's plain reference
(``perfbench/reference/models/transfuser.py``,
``perfbench/reference/policy/transfuser_policy.py``) bit for bit, with
planted faults; the parameter and FLOP counts; the policy's device marks;
and the benchmark's TransFuser rollout harness
(``perfbench/drivers/transfuser_rollout.py``) at a small size, sound and
with planted faults.  The model has no counterpart in the JAX package."""

import os
import subprocess
import sys
import time

import pytest
import torch

from oatomobile_torch.baselines.learned.transfuser import (
    make_transfuser_policy)
from oatomobile_torch.baselines.learned.transfuser import policy as tf_policy
from oatomobile_torch.envs.batched import BatchedEnv
from oatomobile_torch.models.transfuser import TransFuser
from oatomobile_torch.utils import profiling
from perfbench import registry
from perfbench.check import failed
from perfbench.counts import transfuser_flops
from perfbench.drivers import transfuser_rollout
from perfbench.reference import rollout as ref_rollout
from perfbench.reference.policy.transfuser_policy import (
    TransFuserPolicy as RefPolicy)

torch.set_num_threads(1)

SEED = 2**31 + 23
SCENES = 2
ENV_KWARGS = dict(num_vehicles=4, max_episode_steps=1500,
                  route_capacity=512, seed=7)
CELL = "transfuser-town01-b256"


def _program_model(weights) -> TransFuser:
  model = TransFuser(device="meta")
  model.to_empty(device="cpu")
  model.load_state_dict(weights, strict=True)
  return model.eval()


@pytest.fixture(scope="module")
def env():
  return BatchedEnv("Town02", SCENES, device="cpu", **ENV_KWARGS)


@pytest.fixture(scope="module")
def inputs(env):
  """The program's observation of the Town02 scenes' first state."""
  obs = tf_policy.observe(env.params, env.state)
  return obs.image, obs.lidar, obs.speed, obs.target_point


@pytest.fixture(scope="module")
def weights(inputs):
  return transfuser_rollout.calibrate(
      transfuser_rollout.draw_weights(SEED, "cpu"), *inputs)


@pytest.fixture(scope="module")
def reference_plan(weights, inputs):
  model = transfuser_rollout._reference_model(weights, "cpu").eval()  # pylint: disable=protected-access
  with torch.no_grad():
    return model(*inputs)


def _plan(model, inputs):
  with torch.no_grad():
    return model(*inputs)


def test_the_model_equals_the_reference_bit_for_bit(weights, inputs,
                                                    reference_plan):
  """Tolerance: none.  The program runs the reference's float32
  operations in the reference's order, so the plan is equal bit for bit;
  the plan is a few metres long, not saturated."""
  plan = _plan(_program_model(weights), inputs)
  assert plan.shape == (SCENES, 4, 2) and plan.dtype == torch.float32
  assert torch.equal(plan, reference_plan)
  assert 0.1 < float(plan.abs().max()) < 20.0


@pytest.mark.parametrize("part,millions", [
    ("all", 66.29), ("image", 21.28), ("lidar", 11.17), ("fusion", 33.65),
    ("head", 0.19)])
def test_the_parameter_count(part, millions):
  model = TransFuser(device="meta")
  enc = model.encoder
  parts = {
      "all": [model],
      "image": [enc.image_encoder],
      "lidar": [enc.lidar_encoder],
      "fusion": [getattr(enc, "transformer{}".format(i)) for i in (1, 2, 3,
                                                                    4)],
      "head": [model.join, model.decoder, model.output],
  }
  count = sum(p.numel() for m in parts[part] for p in m.parameters())
  assert round(count / 1e6, 2) == millions


def _without_fusion(stage: int):

  def fault(model, inputs):
    gpt = getattr(model.encoder, "transformer{}".format(stage))
    # The GPT's maps are zeros: the stage's add leaves the trunks as they
    # were, as if it were left out.
    gpt.forward = lambda image, lidar, velocity: (torch.zeros_like(image),
                                                  torch.zeros_like(lidar))
    return model, inputs

  return fault


def _target_zeroed(model, inputs):
  image, lidar, speed, target = inputs
  return model, (image, lidar, speed, torch.zeros_like(target))


@pytest.mark.parametrize("fault", [_without_fusion(1), _without_fusion(2),
                                   _without_fusion(3), _without_fusion(4),
                                   _target_zeroed],
                         ids=["fusion1", "fusion2", "fusion3", "fusion4",
                              "target_zeroed"])
def test_a_planted_fault_is_unequal(weights, inputs, reference_plan, fault):
  model, faulty = fault(_program_model(weights), inputs)
  assert not torch.equal(_plan(model, faulty), reference_plan)


def test_the_policy_equals_the_reference_in_the_closed_loop(weights):
  """Two closed-loop steps from the same scenes.  Tolerance: none: the
  bridge switches between throttle and brake on a plan's last bits."""
  env = BatchedEnv("Town02", SCENES, device="cpu", **ENV_KWARGS)
  ref = ref_rollout.ReferenceEnv("Town02", SCENES, device="cpu",
                                 **ENV_KWARGS)
  start = ref_rollout.leaves(env.state)
  initial = ref_rollout.leaves(ref.initial)
  assert all(torch.equal(v, initial[k]) for k, v in start.items())
  policy = make_transfuser_policy(_program_model(weights))
  final, _, stats = env.rollout(2, policy=policy)
  want_state, want_stats = ref.rollout(
      ref_rollout.state_from_leaves(start), 2,
      RefPolicy(transfuser_rollout._reference_model(weights, "cpu")))  # pylint: disable=protected-access
  got = ref_rollout.leaves(final)
  want = ref_rollout.leaves(want_state)
  assert set(got) == set(want)
  for k in want:
    assert torch.equal(got[k], want[k]), k
  for k in want_stats:
    assert torch.equal(stats[k], want_stats[k]), k
  assert bool((stats["distance"] > 0).any())


def test_a_call_marks_its_stages_with_their_counts(weights, env):
  policy = make_transfuser_policy(_program_model(weights))
  profiling.reset()
  try:
    policy(env.params, env.state)
    snap = profiling.snapshot()
  finally:
    profiling.reset()
  for name, count in {"transfuser.observe": 1, "transfuser.encode": 4,
                      "transfuser.decode": 4, "transfuser.act": 1}.items():
    (sample,) = snap[name]["samples"]
    assert sample.count == count and sample.parent is None, name
    assert sample.ms > 0.0
  fuse = snap["transfuser.fuse"]["samples"]
  trunk = snap["transfuser.trunk"]["samples"]
  assert [s.count for s in fuse] == [8, 8, 8, 8]
  assert [s.count for s in trunk] == [5, 6, 8, 5]
  assert all(s.parent == "transfuser.encode" and s.ms > 0.0
             for s in fuse + trunk)
  # The stages split the encoder: trunk, fuse, trunk, ... back to back.
  encode = snap["transfuser.encode"]["samples"][0].ms
  assert sum(s.ms for s in fuse + trunk) <= encode


def test_the_flop_count_is_the_published_model_s():
  flops = transfuser_flops.flops_per_scene()
  assert abs(flops / 23.26e9 - 1.0) < 0.005
  cell = registry.cell(CELL, registry.benchmark())
  assert transfuser_flops.closed_loop_step_flops(cell["config"],
                                                 256) == 256 * flops


SMALL = {"scenes": 2, "check_within": 2}
RUN_SEED = 2**31 + 103


def _cell():
  cell = registry.cell(CELL, registry.benchmark())
  return cell, dict(cell["traffic"], **SMALL)


def test_the_rollout_harness_reads_correct_on_a_sound_run():
  cell, _ = _cell()
  result = transfuser_rollout.run(cell, seed=RUN_SEED, seconds=0.1,
                                  trace=False, control=False, device="cpu",
                                  process_start=time.perf_counter(),
                                  overrides=SMALL)
  assert {c.name: c.value for c in result.checks} == {
      "init_mismatch": 0, "state_gap": 0.0}
  assert failed(result.checks) == 0
  assert result.notes["plan_gap"] == 0.0
  assert result.end_to_end["env_steps_per_s"] > 0


def _checks_past_the_warm_up():
  """The harness's check (``transfuser_rollout.compare``) of one chunk of
  the program on the cell's scene batch at a small size, with every
  scene's step counter first set to 150: past the bridge's warm-up floor
  the plan sets each scene's target speed."""
  cell, traffic = _cell()
  config = cell["config"]
  env = BatchedEnv(traffic["town"], int(traffic["scenes"]),
                   num_vehicles=traffic["vehicles"],
                   max_episode_steps=traffic["max_episode_steps"],
                   route_capacity=traffic["route_capacity"],
                   seed=transfuser_rollout.env_seed(RUN_SEED), device="cpu")
  weights = transfuser_rollout._weights(RUN_SEED, env, "cpu")  # pylint: disable=protected-access
  initial = ref_rollout.leaves(env.state)
  env._state.step.fill_(150)  # pylint: disable=protected-access
  before = env.state
  policy = transfuser_rollout._policy(weights, "cpu", reference=False)  # pylint: disable=protected-access
  plan = transfuser_rollout._program_plan(policy, env.params, before)  # pylint: disable=protected-access
  after, _, stats = env.rollout(int(traffic["chunk_steps"]), policy=policy)
  kept = {0: (ref_rollout.leaves(before), ref_rollout.leaves(after), stats)}
  return transfuser_rollout.compare(config, traffic, RUN_SEED, weights,
                                    initial, kept, {0: plan}, False, "cpu")


def test_the_check_past_the_warm_up_is_correct():
  checks, notes = _checks_past_the_warm_up()
  assert {c.name: c.value for c in checks} == {"init_mismatch": 0,
                                               "state_gap": 0.0}
  assert notes["plan_gap"] == 0.0


def _fusion_left_out(monkeypatch):
  encode = tf_policy.TransFuser.encode

  def broken(model, image, lidar, speed):
    model.encoder.transformer3.forward = _zero_maps
    return encode(model, image, lidar, speed)

  monkeypatch.setattr(tf_policy.TransFuser, "encode", broken)


def _zero_maps(image, lidar, velocity):
  del velocity
  return torch.zeros_like(image), torch.zeros_like(lidar)


def _target_point_zeroed(monkeypatch):
  observe = tf_policy.observe

  def broken(*args, **kwargs):
    obs = observe(*args, **kwargs)
    obs.target_point = torch.zeros_like(obs.target_point)
    return obs

  monkeypatch.setattr(tf_policy, "observe", broken)


@pytest.mark.parametrize("fault", [_fusion_left_out, _target_point_zeroed])
def test_a_planted_fault_is_not_correct(monkeypatch, fault):
  fault(monkeypatch)
  checks, notes = _checks_past_the_warm_up()
  assert failed(checks) > 0
  assert notes["plan_gap"] > 0.0


def _top_modules(imports: str) -> set:
  code = ("import sys\n" + imports +
          "\nprint(' '.join(sorted({m.split('.', 1)[0] "
          "for m in sys.modules})))")
  env = dict(os.environ, PYTHONPATH=registry.ROOT)
  out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=registry.ROOT, env=env, timeout=300,
                       check=True)
  return set(out.stdout.split())


@pytest.mark.parametrize("imports,forbidden", [
    ("import perfbench.reference.policy.transfuser_policy\n"
     "import perfbench.counts.transfuser_flops\n",
     {"jax", "jaxlib", "flax", "optax", "oatomobile_tpu",
      "oatomobile_torch"}),
    ("import perfbench.drivers.transfuser_rollout\n"
     "import oatomobile_torch.baselines.learned.transfuser\n",
     {"jax", "jaxlib", "flax", "optax", "oatomobile_tpu"}),
], ids=["reference", "harness"])
def test_what_the_cell_loads(imports, forbidden):
  """The reference (model, policy, camera) loads nothing of the program
  and no JAX; the cell's driver and the policy load no JAX."""
  tops = _top_modules(imports)
  assert not tops & forbidden, tops & forbidden


def test_the_existing_packages_do_not_import_transfuser():
  """Only what runs TransFuser loads it: ``models`` and
  ``baselines.learned`` leave it out."""
  tops = _top_modules("import oatomobile_torch.models\n"
                      "import oatomobile_torch.baselines.learned\n"
                      "import oatomobile_torch.envs.batched\n"
                      "print(' '.join(m for m in sys.modules "
                      "if 'transfuser' in m or 'resnet' in m))\n")
  assert "oatomobile_torch" in tops
  assert not {t for t in tops if "transfuser" in t or "resnet" in t}
