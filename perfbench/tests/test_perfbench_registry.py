"""The harness finds a cell's files by the names in BENCHMARK.json: a new
configuration, traffic mix or per-layer metric is new files and entries,
with no edit to a file that is there."""

import json
import os
import shutil

import pytest

from perfbench import registry


def _bench():
  return registry.benchmark()


def test_every_name_resolves_to_its_files():
  bench = _bench()
  for entry in bench["workloads"]:
    cell = registry.cell(entry["name"], bench)
    assert cell["config"]["name"] == entry["config"]
    registry.driver(cell["traffic"]["driver"])
    assert cell["end_to_end"] and cell["per_layer"]
  for config in bench["configs"]:
    assert os.path.exists(os.path.join(registry.ROOT, config["file"]))
  for metric in bench["per_layer"]:
    assert callable(registry.reader(metric["name"]).read)


def test_a_new_cell_config_and_metric_are_found_by_name(tmp_path):
  """Copies the package's data into a scratch tree, adds one file of each
  kind and an entry for each, and finds them: no existing file changes."""
  package = tmp_path / "perfbench"
  for kind in ("configs", "workloads", "metrics"):
    shutil.copytree(os.path.join(registry.PACKAGE_DIR, kind), package / kind)
  before = {p: p.read_bytes() for p in package.rglob("*") if p.is_file()}
  bench = _bench()
  (package / "configs" / "dim_small.json").write_text(json.dumps(
      dict(registry.config("dim"), name="dim_small")))
  traffic = dict(registry.workload("dim-town01-b1024"), scenes=256)
  (package / "workloads" / "dim-town02-b256.json").write_text(
      json.dumps(traffic))
  (package / "metrics" / "new.metric_ms.py").write_text(
      "def read(ctx):\n  return ctx.get('x')\n")
  bench["configs"].append({"name": "dim_small", "source": "x",
                           "file": "perfbench/configs/dim_small.json",
                           "reduced": [], "why": "x"})
  bench["workloads"].append({"name": "dim-town02-b256",
                             "config": "dim_small",
                             "traffic": "dim-town02-b256", "chips": 1,
                             "why": "x"})
  bench["per_layer"].append({"name": "new.metric_ms", "unit": "ms",
                             "better": "lower", "source": "device_trace",
                             "layer": "world", "moves": "env_steps_per_s",
                             "workloads": ["dim-town02-b256"]})
  for m in bench["end_to_end"]:
    if "workloads" in m:
      m["workloads"].append("dim-town02-b256")
  cell = registry.cell("dim-town02-b256", bench, package_dir=str(package))
  assert cell["traffic"]["scenes"] == 256
  assert cell["config"]["name"] == "dim_small"
  assert "new.metric_ms" in [m["name"] for m in cell["per_layer"]]
  reader = registry.reader("new.metric_ms", package_dir=str(package))
  assert reader.read({"x": 1.5}) == 1.5
  for path, data in before.items():
    assert path.read_bytes() == data


def test_an_unknown_cell_is_refused():
  with pytest.raises(KeyError):
    registry.cell("no-such-cell", _bench())
