"""BENCHMARK.json keeps to the benchmark's contract: keys, names, units,
lengths and the metrics every cell reports."""

import json
import os
import re

from perfbench import registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def _bench():
  return registry.benchmark()


def _line(text):
  return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
  bench = _bench()
  assert set(bench) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
  assert 1 <= bench["run_seconds"] <= 51
  assert len(bench["command"]) <= 32 and all(_line(w)
                                            for w in bench["command"])
  for p in bench["paths"]:
    assert PATH.match(p) and ".." not in p and not p.startswith("/")
  size = os.path.getsize(os.path.join(registry.ROOT, "BENCHMARK.json"))
  assert size <= 64 * 1024


def test_names_units_and_lines():
  bench = _bench()
  names = []
  for c in bench["configs"]:
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(c["name"]) and _line(c["why"]) and _line(c["source"])
    assert all(NAME.match(k) for k in c["reduced"])
    assert len(c["reduced"]) <= 16
    assert c["file"].startswith(bench["paths"][0] + "/")
  for w in bench["workloads"]:
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert w["chips"] in (1, 4) and _line(w["why"])
  for m in bench["end_to_end"] + bench["per_layer"]:
    allowed = {"name", "unit", "better", "source", "workloads"}
    allowed |= ({"bound"} if m in bench["end_to_end"]
                else {"layer", "moves"})
    assert set(m) <= allowed and NAME.match(m["name"])
    assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    names.append(m["name"])
  for m in bench["end_to_end"]:
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25
  for m in bench["per_layer"]:
    assert _line(m["layer"])
    assert m["source"] in ("device_trace", "program_span",
                           "program_counter", "host_clock")
  assert len(names) == len(set(names))
  cells = [w["name"] for w in bench["workloads"]]
  assert len(cells) == len(set(cells))
  assert "setup_s" in names


def test_every_cell_reports_setup_another_metric_and_a_layer():
  bench = _bench()
  for w in bench["workloads"]:
    cell = registry.cell(w["name"], bench)
    e2e = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell["per_layer"]
  layers = {}
  for m in bench["per_layer"]:
    assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
    for cell in m.get("workloads", []):
      owner = [e for e in bench["end_to_end"] if e["name"] == m["moves"]][0]
      assert cell in owner.get("workloads", [cell])
    layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
  assert all(len(v) == 1 for v in layers.values())


def test_roofline_and_mfu_are_percent():
  for m in _bench()["per_layer"]:
    if m["name"].endswith("_roofline") or "mfu" in m["name"]:
      assert m["unit"] == "%"


def test_traffic_files_are_data():
  for w in _bench()["workloads"]:
    path = os.path.join(registry.PACKAGE_DIR, "workloads",
                        w["traffic"] + ".json")
    with open(path) as fp:
      traffic = json.load(fp)
    assert {"driver", "limits"} <= set(traffic)
