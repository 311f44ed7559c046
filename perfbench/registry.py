"""Finds what belongs to a name in ``BENCHMARK.json``: a configuration's
file, a traffic mix's file, a per-layer metric's reader and a cell's
driver.  Nothing here lists names: adding a configuration, a cell or a
metric is adding its files and its entries.

  - ``perfbench/configs/<config>.json``: one configuration;
  - ``perfbench/workloads/<cell>.json``: one traffic mix, with the
    ``driver`` that runs it and the limits of its comparison;
  - ``perfbench/metrics/<metric>.py``: one reader, ``read(ctx)``;
  - ``perfbench/drivers/<driver>.py``: one entry of the program.
"""

import importlib
import importlib.util
import json
import os
from typing import Any, Dict, List

PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PACKAGE_DIR)


def _json(path: str) -> Dict[str, Any]:
  with open(path) as fp:
    return json.load(fp)


def benchmark(root: str = ROOT) -> Dict[str, Any]:
  return _json(os.path.join(root, "BENCHMARK.json"))


def config(name: str, package_dir: str = PACKAGE_DIR) -> Dict[str, Any]:
  return _json(os.path.join(package_dir, "configs", name + ".json"))


def workload(name: str, package_dir: str = PACKAGE_DIR) -> Dict[str, Any]:
  return _json(os.path.join(package_dir, "workloads", name + ".json"))


def reader(name: str, package_dir: str = PACKAGE_DIR):
  """The module of ``metrics/<name>.py`` (names hold dots, so it is
  loaded from its path)."""
  path = os.path.join(package_dir, "metrics", name + ".py")
  spec = importlib.util.spec_from_file_location(
      "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module


def driver(name: str):
  return importlib.import_module("perfbench.drivers." + name)


def cell(name: str, bench: Dict[str, Any],
         package_dir: str = PACKAGE_DIR) -> Dict[str, Any]:
  """Everything a run of cell ``name`` needs: its ``BENCHMARK.json``
  entry, its traffic file, its configuration, and the metrics it
  reports (end-to-end, per-layer), each with its entry."""
  entries = [w for w in bench["workloads"] if w["name"] == name]
  if len(entries) != 1:
    raise KeyError("cell {!r}: {} entries in BENCHMARK.json".format(
        name, len(entries)))
  entry = entries[0]

  def reports(metric) -> bool:
    return name in metric.get("workloads", [name])

  end_to_end: List[Dict] = [m for m in bench["end_to_end"] if reports(m)]
  names = {m["name"] for m in end_to_end}
  per_layer = [m for m in bench["per_layer"]
               if reports(m) and m["moves"] in names]
  return {
      "name": name,
      "entry": entry,
      "traffic": workload(entry["traffic"], package_dir),
      "config": config(entry["config"], package_dir),
      "end_to_end": end_to_end,
      "per_layer": per_layer,
  }
