"""The diagnostics' captured step (``experiments/diag/common.run``) against
its plain loop (``common.run_eager``) on the CPU, exactly, with the card's
capture and replay played by ``FakeCapturedStep``
(``tests/test_torch_compiled.py``): the autopilot's stop forensics, the
crash snapshots latched into nested accumulators, the traces written at
the step counter, and a learned policy's failure taxonomy with one splat
launch a step.  ``run`` changes neither the states nor the accumulators
it is given.
"""

import numpy as np
import pytest
import torch

from oatomobile_torch.baselines.learned.rip.policy import make_rip_policy
from oatomobile_torch.experiments.diag import (busytown_viz, common, hills,
                                               hero_stops, learned_failures)
from oatomobile_torch.models import ImitativeModel
from oatomobile_torch.ops import bev_cuda
from oatomobile_torch.sim.types import scene_state_to_numpy
from oatomobile_torch.sim.util import constant
from test_torch_compiled import (FakeCapturedStep, assert_trees_equal,  # pylint: disable=unused-import
                                 fake_card)

torch.set_num_threads(1)


def both(params, states, policy, accumulate, m0, steps, freeze=True):
  """(captured, eager) results as numpy trees, the inputs unchanged."""
  before = (scene_state_to_numpy(states), common.host(m0))
  got = common.run(params, states, policy, accumulate, m0, steps, "cpu",
                   freeze=freeze)
  want = common.run_eager(params, states, policy, accumulate, m0, steps,
                          freeze=freeze)
  assert_trees_equal(scene_state_to_numpy(states), before[0])
  assert_trees_equal(common.host(m0), before[1])
  return [(common.host(m), scene_state_to_numpy(s)) for m, s in (got, want)]


def assert_runs_equal(got, want):
  for g, w in zip(got, want):
    assert_trees_equal(g, w)


@pytest.mark.parametrize("card", [False, True], ids=["cpu", "fake_card"])
def test_hero_stops_captured_equals_eager(card, request):
  if card:
    request.getfixturevalue("fake_card")
  _, configs = hero_stops.task_configs("Town02", 3)
  params, states = common.scenes("Town02", configs, 1, 0, "cpu")
  got, want = both(params, states, common.autopilot,
                   hero_stops.make_accumulate(params),
                   hero_stops.initial(3, "cpu"), 20, freeze=False)
  assert_runs_equal(got, want)
  assert got[0]["moving_steps"].sum() > 0
  if card:
    assert len(FakeCapturedStep.instances) == 1
    assert FakeCapturedStep.instances[0].captured
    assert bev_cuda.launches == 0  # the autopilot reads no LIDAR


def test_crash_snapshots_and_traces_equal_eager(fake_card):  # pylint: disable=redefined-outer-name,unused-argument
  """Straight ahead at full throttle: Hills scenes crash and latch their
  snapshot (nested accumulators); the BusyTown viz's traces fill at the
  step counter."""
  def straight(params, s):
    del params
    return constant((1.0, 0.0, 0.0), s.hero_xy.device).expand(
        s.batch_size, 3), s

  ids, _, params, states = hills.family_scenes("Hills", 1, "cpu")
  got, want = both(params, states, straight, hills.make_accumulate(params),
                   hills.initial(params, states), 80)
  assert_runs_equal(got, want)
  m = got[0]
  assert m["collided"].any() and len(ids) == 4
  crashed = np.flatnonzero(m["collided"])
  assert (m["crash"]["hero_speed"][crashed] > 0).all()
  # A scene that did not crash keeps its zero snapshot.
  assert (m["crash"]["hero_speed"][~m["collided"]] == 0).all()

  _, params, states = common.carnovel_scenes(["BusyTown7-v0"], 2, 7, "cpu")
  horizon = 65
  got, want = both(params, states, common.autopilot, busytown_viz.accumulate,
                   busytown_viz.initial(states, horizon), horizon)
  assert_runs_equal(got, want)
  m, final = got
  assert m["t"].tolist() == [horizon]
  np.testing.assert_array_equal(m["trace_v"][-1], final["hero_speed"])
  assert m["trace_xy"].shape == (3, 2, 2)  # steps 0, 30 and 60
  assert (m["trace_xy"] != 0).all()


def test_learned_policy_captured_equals_eager_one_splat_a_step(fake_card):  # pylint: disable=redefined-outer-name
  """RIP-WCM over two narrow members (32x32 input, 2 plan steps) through
  the failure taxonomy: the captured run equals the eager one and its
  policy launches the splat once a step."""
  models = [ImitativeModel((4, 2), (32, 32),
                           generator=torch.Generator().manual_seed(seed),
                           device="cpu") for seed in range(2)]
  policy = make_rip_policy(models, algorithm="WCM", num_plan_steps=2)
  configs = list(learned_failures.suite_tasks("corl2017", "Town02",
                                              2).values())
  params, states = common.scenes("Town02", configs, 1, 7, "cpu")
  steps = 6
  m0 = learned_failures.initial(2, "cpu")
  got = common.run(params, states, policy,
                   learned_failures.make_accumulate(params), m0, steps, "cpu")
  assert bev_cuda.launches == steps
  assert len(fake_card) == 1 and fake_card[0].captured
  want = common.run_eager(params, states, policy,
                          learned_failures.make_accumulate(params), m0, steps)
  assert_trees_equal(common.host(got[0]), common.host(want[0]))
  assert_trees_equal(scene_state_to_numpy(got[1]),
                     scene_state_to_numpy(want[1]))
  assert (common.host(got[0])["steps"] == steps).all()
