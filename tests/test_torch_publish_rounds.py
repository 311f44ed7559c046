"""``oatomobile_torch.experiments.publish_r3`` and ``publish_r4`` against
the JAX package's ``scripts/post_experiment_r3.py`` and
``post_experiment_r4.py`` on the same seeded run directory.

The JAX scripts write into the repository's ``docs/results_r3`` and
``docs/results_r4`` and patch ``README.md``: here their ``DOCS`` is
pointed at a temporary directory and ``ROOT`` (``patch_readme``'s) at a
temporary README with the results markers, so no test writes into
``docs/`` or ``README.md``.  Held: ``RESULTS.md`` equal byte for byte,
the same file names copied, and nothing written outside the run's
directory by the port.
"""

import json
import os

import numpy as np
import pytest

from oatomobile_torch.experiments import publish, publish_r3, publish_r4
from test_torch_experiments import _summary, jax_script

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Rows in an order that is not ``publish.ORDER``: round 3 renders them as
# the evaluation wrote them, round 4 in ORDER.
CARNOVEL_ROWS = ["rip_wcm", "autopilot", "rip_bcm", "dim", "cil", "rip_ma"]
CORL_ROWS = ["dim", "autopilot", "rip_wcm", "cil"]


def seeded_run(out: str, seed: int, with_families: bool = True) -> dict:
  """A run directory as the pipeline leaves it: the CARNOVEL rows in
  ``tables.json`` and the CoRL2017 rows in ``tables_corl.json`` (split
  evaluations), every row's ``summary.json`` (per-family tables on
  RIP-WCM and DIM), the RIP and CIL training logs."""
  rs = np.random.RandomState(seed)
  tables = {"carnovel": {n: _summary(rs, ["Hills", "BusyTown"])
                         for n in CARNOVEL_ROWS},
            "corl2017": {n: _summary(rs, ["Town01_FullTown"])
                         for n in CORL_ROWS}}
  if not with_families:
    tables["carnovel"]["rip_wcm"]["per_family"] = {}
  os.makedirs(out)
  for suite, rows in tables.items():
    for name, summary in rows.items():
      row_dir = os.path.join(out, "{}_{}".format(suite, name))
      os.makedirs(row_dir)
      with open(os.path.join(row_dir, "summary.json"), "w") as fp:
        json.dump({"summary": summary, "tasks": {}}, fp)
  for name, rows in (("tables.json", {"carnovel": tables["carnovel"]}),
                     ("tables_corl.json", {"corl2017": tables["corl2017"]})):
    with open(os.path.join(out, name), "w") as fp:
      json.dump(rows, fp)
  for label in ("rip", "cil"):
    os.makedirs(os.path.join(out, label, "logs"))
    with open(os.path.join(out, label, "logs",
                           "{}_train.jsonl".format(label)), "w") as fp:
      fp.write(json.dumps({"epoch": 0, "loss": float(rs.rand())}) + "\n")
  return tables


def _read(path: str) -> bytes:
  with open(path, "rb") as fp:
    return fp.read()


@pytest.fixture
def repo_records():
  """The JAX rounds' records in the repository, which no test may write."""
  paths = [os.path.join(ROOT, "README.md")]
  for name in ("results_r3", "results_r4"):
    folder = os.path.join(ROOT, "docs", name)
    if os.path.isdir(folder):
      paths += [os.path.join(folder, f) for f in sorted(os.listdir(folder))]
  before = {p: _read(p) for p in paths}
  yield
  assert {p: _read(p) for p in paths} == before


@pytest.mark.parametrize("with_families", [True, False])
def test_publish_r3_matches_jax(tmp_path, with_families, repo_records):
  del repo_records
  out = str(tmp_path / "run")
  tables = seeded_run(out, 1, with_families)
  module = jax_script("post_experiment_r3", dict(RUN_OUT=out))
  module.DOCS = str(tmp_path / "jax_docs")
  module.main()
  path = publish_r3.publish_r3(out)
  assert path == os.path.join(out, "results_r3", "RESULTS.md")
  assert _read(path) == _read(os.path.join(module.DOCS, "RESULTS.md"))
  assert sorted(os.listdir(os.path.dirname(path))) == sorted(
      os.listdir(module.DOCS))
  text = _read(path).decode()
  # Insertion order, not ORDER.
  agents = [line.split(" | ")[0][2:] for line in text.splitlines()
            if line.startswith("| ") and "%" in line and
            not line.startswith("| Hills") and
            not line.startswith("| BusyTown") and
            not line.startswith("| Town01")]
  assert agents == [publish.POLICY_LABELS[n] for n in
                    CARNOVEL_ROWS + CORL_ROWS]
  assert tables["carnovel"]["rip_wcm"]["episodes"] > 0
  assert sorted(os.listdir(str(tmp_path))) == ["jax_docs", "run"]


@pytest.mark.parametrize("with_families", [True, False])
def test_publish_r4_matches_jax(tmp_path, with_families, repo_records):
  del repo_records
  out = str(tmp_path / "run")
  seeded_run(out, 2, with_families)
  module = jax_script("post_experiment_r4", dict(RUN_OUT=out))
  module.DOCS = str(tmp_path / "jax_docs")
  module.ROOT = str(tmp_path / "jax_root")
  os.makedirs(module.ROOT)
  readme = os.path.join(module.ROOT, "README.md")
  with open(readme, "w") as fp:
    fp.write("head\n<!-- RESULTS:BEGIN -->\nold\n<!-- RESULTS:END -->\n")
  module.main()
  path = publish_r4.publish_r4(out)
  assert path == os.path.join(out, "results_r4", "RESULTS.md")
  assert _read(path) == _read(os.path.join(module.DOCS, "RESULTS.md"))
  assert sorted(os.listdir(os.path.dirname(path))) == sorted(
      os.listdir(module.DOCS))
  # The JAX script's README block is the text after the title; the port
  # writes no README.
  body = _read(readme).decode()
  assert publish_r4.HEADER in body
  assert sorted(os.listdir(str(tmp_path))) == ["jax_docs", "jax_root", "run"]
  text = _read(path).decode()
  agents = [line.split(" | ")[0][2:] for line in text.splitlines()
            if line.startswith("| ") and "±" in line and "Family" not in line
            and line.split(" | ")[0][2:] in publish.POLICY_LABELS.values()]
  assert agents == [publish.POLICY_LABELS[n] for n in publish.ORDER] + [
      publish.POLICY_LABELS[n] for n in publish.ORDER if n in CORL_ROWS]


def test_render_table_orders(tmp_path):
  del tmp_path
  rs = np.random.RandomState(3)
  rows = {n: _summary(rs, []) for n in ("dim", "autopilot", "x")}
  ordered = publish.render_table("S", rows)
  own = publish.render_table("S", rows, order=None)
  assert [l.split(" | ")[0] for l in ordered.splitlines()[4:]] == [
      "| Autopilot (expert)", "| DIM"]
  assert [l.split(" | ")[0] for l in own.splitlines()[4:]] == [
      "| DIM", "| Autopilot (expert)", "| x"]
