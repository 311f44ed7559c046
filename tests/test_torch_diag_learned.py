"""``oatomobile_torch.experiments.diag.learned_failures`` against the JAX
package's ``scripts/diag_learned_failures.py`` on the CPU: both read the
same JAX-format checkpoints of seeded weights (a K = 4 ensemble, the
JAX script's size, and CIL) and run three CoRL2017 Town02 tasks, one
episode each.  Seeded CIL weights drive every scene off the road within
40 steps, so the first-collision forensics latch: the ``--out`` rows must
match key for key (the JAX layout), integers and booleans equal, floats
within ``float_atol(40)`` (the FMA drift of a 40-step run, as
``tests/test_torch_diag.py`` states it), and the printed report must be
the JAX script's.
"""

import contextlib
import importlib.util
import io
import json
import os

import jax
import numpy as np
import pytest
import torch

from oatomobile_torch.experiments import pipeline
from oatomobile_torch.experiments.diag import learned_failures
from test_torch_diag import float_atol
from test_torch_experiments import write_jax_checkpoints
from test_torch_models import dim_context, random_tree
from test_torch_policies import _jax_dim

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HORIZON = 40
ARGV = ["--suite", "corl2017", "--town", "Town02", "--episodes", "1",
        "--horizon", str(HORIZON), "--max-tasks", "3"]


@pytest.fixture(scope="module")
def ckpt_root(tmp_path_factory):
  """The JAX trainers' best checkpoints: K = 4 DIM members and CIL."""
  import jax.numpy as jnp  # pylint: disable=import-outside-toplevel
  from oatomobile_tpu import models as jmodels  # pylint: disable=import-outside-toplevel
  dims = [tree for _, tree in (_jax_dim(seed) for seed in
                               range(learned_failures.NUM_MODELS))]
  ctx = dict(dim_context(1, 0), mode=np.zeros((1, 1), np.float32))
  cil = random_tree(jmodels.BehaviouralModel(),
                    **{k: jnp.asarray(v) for k, v in ctx.items()})
  root = str(tmp_path_factory.mktemp("ckpts"))
  write_jax_checkpoints(root, {"dim": dims, "cil": cil})
  return root


def jax_main(argv) -> str:
  spec = importlib.util.spec_from_file_location(
      "jax_diag_learned_failures",
      os.path.join(ROOT, "scripts", "diag_learned_failures.py"))
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  out = io.StringIO()
  with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
    mp.setattr("sys.argv", ["diag_learned_failures.py"] + list(argv))
    module.main()
  return out.getvalue()


def test_cil_failures_match_jax(ckpt_root, tmp_path):  # pylint: disable=redefined-outer-name
  argv = ARGV + ["--policy", "cil", "--ckpt-root", ckpt_root]
  want_out = jax_main(argv + ["--out", str(tmp_path / "jax.json")])
  got_out = io.StringIO()
  with contextlib.redirect_stdout(got_out):
    learned_failures.main(argv + ["--cpu", "--out",
                                  str(tmp_path / "torch.json")])
  assert got_out.getvalue().replace("torch.json", "jax.json") == want_out
  rows = {}
  for side in ("jax", "torch"):
    with open(tmp_path / (side + ".json")) as fp:
      rows[side] = json.load(fp)
  assert len(rows["torch"]) == len(rows["jax"]) == 3
  for got, want in zip(rows["torch"], rows["jax"]):
    assert list(got) == list(want)
    for k, v in want.items():
      if isinstance(v, float):
        assert abs(got[k] - v) <= float_atol(HORIZON), k
      else:
        assert got[k] == v, k
  # Every episode crashed, into the static geometry, and was latched.
  assert all(r["collided"] and r["impact_static"] and r["fail_step"] > 0
             for r in rows["jax"])


def test_build_policy_reads_both_formats(ckpt_root, tmp_path):  # pylint: disable=redefined-outer-name
  """The ``.flax`` ensemble and CIL and the same weights as the port's
  ``.pt`` give the same DIM (member 0) and CIL actions on one state; the
  ensemble must hold NUM_MODELS members."""
  from oatomobile_torch.baselines.learned.rip.train import stack_params  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.utils.checkpoint import Checkpointer  # pylint: disable=import-outside-toplevel
  pt_root = str(tmp_path / "pt")
  members = pipeline.read_ensemble(os.path.join(ckpt_root, "rip", "ckpts"),
                                   device="cpu")
  Checkpointer(os.path.join(pt_root, "rip", "ckpts"),
               prefix="ensemble").save_named("best", stack_params(members))
  cil = pipeline.read_cil(os.path.join(ckpt_root, "cil", "ckpts"), "cpu")
  Checkpointer(os.path.join(pt_root, "cil", "ckpts")).save_named(
      "best", cil.state_dict())
  tasks = learned_failures.suite_tasks("corl2017", "Town02", 2)
  params, states = learned_failures.common.scenes(
      "Town02", list(tasks.values()), 1, 7, "cpu")
  bridge = json.loads(pipeline.BRIDGE)
  for name in ("dim", "cil"):
    actions = [learned_failures.build_policy(name, root, bridge, "cpu")(
        params, states)[0] for root in (ckpt_root, pt_root)]
    assert torch.equal(actions[0], actions[1]), name
  Checkpointer(os.path.join(pt_root, "rip", "ckpts"),
               prefix="ensemble").save_named("best",
                                             stack_params(members[:2]))
  with pytest.raises(ValueError, match="2 members"):
    learned_failures.build_policy("rip_wcm", pt_root, bridge, "cpu")
  assert (learned_failures.build_policy("autopilot", pt_root, bridge, "cpu")
          is learned_failures.common.autopilot)


def test_collision_kind_matches_jax_on_crashed_states():
  """The three branches, scene by scene, on initial states with the heroes
  moved off the road and an NPC put on a hero, against the JAX script's
  one-scene function under ``vmap``."""
  spec = importlib.util.spec_from_file_location(
      "jax_diag_learned_failures_kind",
      os.path.join(ROOT, "scripts", "diag_learned_failures.py"))
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  from oatomobile_torch.sim.types import scene_state_from_numpy  # pylint: disable=import-outside-toplevel
  from test_torch_diag import jax_scenes  # pylint: disable=import-outside-toplevel
  from torch_port_helpers import jax_state_to_numpy  # pylint: disable=import-outside-toplevel
  ids = sorted(learned_failures.suite_tasks("corl2017", "Town02", 4))
  jparams, jstates = jax_scenes(ids, 1, 7)
  # Move the heroes sideways by 0, 8, 16 and 32 m (some boxes leave the
  # road) and put scene 0's first NPC on its hero.
  shift = np.stack([np.zeros(4), [0.0, 8.0, 16.0, 32.0]], -1)
  hero_xy = jstates.hero_xy + shift.astype(np.float32)
  jstates = jstates.replace(
      hero_xy=hero_xy, npc_xy=jstates.npc_xy.at[0, 0].set(hero_xy[0]),
      npc_alive=jstates.npc_alive.at[0, 0].set(True))
  want = jax.device_get(jax.vmap(
      lambda s: module.collision_kind(jparams, s))(jstates))
  params, _ = learned_failures.common.scenes(
      "Town02", [pipeline.suites()["corl2017"][t] for t in ids], 1, 7, "cpu")
  got = learned_failures.collision_kind(
      params, scene_state_from_numpy(jax_state_to_numpy(jstates), "cpu"))
  for g, w in zip(got, want):
    np.testing.assert_array_equal(g.numpy(), np.asarray(w))
  npc, _, static = (np.asarray(w) for w in want)
  assert npc[0] and static.any() and not static.all()
