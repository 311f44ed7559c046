"""Renders a run's results: ``RESULTS.md`` from its tables.  Port of the
JAX package's ``scripts/post_experiment_r5.py`` (its renderers and the
fidelity caveat, word for word).

    python -m oatomobile_torch.experiments.publish

Reads ``RUN_OUT/tables*.json`` (``pipeline``) and writes
``RUN_OUT/results/``: the merged ``tables.json``, ``RESULTS.md``, each
suite's policy summaries and the RIP and CIL training logs.  It writes
nothing outside the run's output directory (the JAX publisher also
patched the repository's README).  The text states the episodes per task
as the summaries hold them, and the horizon as RUN_HORIZON gives it (the
pipeline's knob: set it as the run had it).  Knobs: RUN_OUT, RUN_HORIZON.
"""

import glob
import json
import os
import shutil
from typing import Mapping, Optional, Sequence

from oatomobile_torch.experiments import pipeline

# Emitted above every results table: the single source of the caveat.
FIDELITY_CAVEAT = (
    "> **Fidelity caveat.** These towns are procedural geometric "
    "analogues of the CARLA maps (`oatomobile_tpu/maps/towns.py`), not "
    "the OpenDrive originals, and the golden-replay test is a "
    "determinism guard, not agreement with held-back CARLA episodes "
    "(no CARLA server exists in this environment). Success/collision/"
    "timeout rates are therefore **internally comparable** — across "
    "agents, rounds, and ablations run in this framework — but are NOT "
    "comparable to the absolute numbers in the CARNOVEL/CoRL2017 "
    "papers, which were measured in CARLA.\n")

POLICY_LABELS = {
    "autopilot": "Autopilot (expert)",
    "cil": "CIL",
    "dim": "DIM",
    "rip_wcm": "RIP-WCM",
    "rip_ma": "RIP-MA",
    "rip_bcm": "RIP-BCM",
}

ORDER = ["autopilot", "cil", "dim", "rip_wcm", "rip_ma", "rip_bcm"]
SUITES = (("carnovel", "CARNOVEL (distribution shift, Towns 03-05)"),
          ("corl2017", "CoRL2017 (in-distribution, Towns 01-02)"))


def fmt_pct(x, ci=None):
  if ci is None:
    return "{:.1f}%".format(100 * x)
  return "{:.1f}% ± {:.1f}".format(100 * x, 100 * ci)


def render_table(suite_name, rows, order: Optional[Sequence[str]] = ORDER):
  """The suite's agent table, its rows in ``order`` (None: the order of
  ``rows``); a policy of ``order`` without a row is left out."""
  lines = [
      "| Agent | Success | Collision | Timeout | Episodes |",
      "|---|---|---|---|---|",
  ]
  for name in list(rows) if order is None else order:
    if name not in rows:
      continue
    s = rows[name]
    lines.append("| {} | {} | {} | {} | {} |".format(
        POLICY_LABELS.get(name, name),
        fmt_pct(s["success_rate"], s.get("success_ci95")),
        fmt_pct(s["collision_rate"]),
        fmt_pct(s["timeout_rate"]),
        s["episodes"]))
  return "### {}\n\n".format(suite_name) + "\n".join(lines) + "\n"


def render_families(title, per_family):
  lines = [
      "| Family | Success | Collision | Timeout |",
      "|---|---|---|---|",
  ]
  for fam, s in per_family.items():
    lines.append("| {} | {} | {} | {} |".format(
        fam, fmt_pct(s["success_rate"], s.get("success_ci95")),
        fmt_pct(s["collision_rate"]), fmt_pct(s["timeout_rate"])))
  return "#### {} per family\n\n".format(title) + "\n".join(lines) + "\n"


def episodes_per_task(out: str, suite: str) -> Optional[int]:
  """Episodes per task of the suite's first policy whose
  ``OUT/<suite>_<policy>/summary.json`` exists (None without one)."""
  for name in ORDER:
    path = os.path.join(out, "{}_{}".format(suite, name), "summary.json")
    if os.path.exists(path):
      with open(path) as fp:
        data = json.load(fp)
      return int(round(data["summary"]["episodes"] / len(data["tasks"])))
  return None


def render(tables: Mapping, out: str,
           horizon: int = pipeline.HORIZON) -> str:
  """The text of ``RESULTS.md`` for ``tables`` (``{suite: {policy:
  summary}}``); the per-family tables come from the first of RIP-WCM,
  DIM and the autopilot whose ``OUT/<suite>_<policy>/summary.json``
  exists."""
  counts = ["{} {} episodes/task".format(label.split(" ")[0], n)
            for suite, label in SUITES
            for n in [episodes_per_task(out, suite)] if n is not None]
  cut = ("" if horizon == pipeline.HORIZON else
         ", the horizon cut to {} steps".format(horizon))
  md = ["# Agent results\n",
        FIDELITY_CAVEAT,
        "All numbers measured with the batched on-device evaluator "
        "(`oatomobile_torch/benchmarks/batched_eval.py`): {}{}, fresh "
        "traffic per episode, 95% binomial CIs.  Learned agents trained on "
        "expert data with a benchmark-density traffic mix and "
        "3x stopped-restart oversampling "
        "(`oatomobile_torch/experiments/pipeline.py`).\n".format(
            ", ".join(counts), cut)]
  for suite, label in SUITES:
    if suite not in tables:
      continue
    md.append(render_table(label, tables[suite]))
    panel = family_panel(tables, out, suite, label)
    if panel:
      md.append(panel)
  return "\n".join(md)


def merge_tables(out: str, results: str) -> dict:
  """``OUT/tables*.json`` merged (split evaluations write several), also
  written to ``results/tables.json``; the RIP and CIL training logs copied
  into ``results``."""
  os.makedirs(results, exist_ok=True)
  tables = {}
  for path in sorted(glob.glob(os.path.join(out, "tables*.json"))):
    with open(path) as fp:
      for suite, rows in json.load(fp).items():
        tables.setdefault(suite, {}).update(rows)
  with open(os.path.join(results, "tables.json"), "w") as fp:
    json.dump(tables, fp, indent=2)
  for log_name in ("rip/logs/rip_train.jsonl", "cil/logs/cil_train.jsonl"):
    src = os.path.join(out, log_name)
    if os.path.exists(src):
      shutil.copy(src, os.path.join(results, os.path.basename(log_name)))
  return tables


def family_panel(tables: Mapping, out: str, suite: str, label: str):
  """The per-family table of the first of RIP-WCM, DIM and the autopilot
  that has a row and an ``OUT/<suite>_<policy>/summary.json`` (None when
  that summary has no families, or no policy has both)."""
  for name in ("rip_wcm", "dim", "autopilot"):
    src = os.path.join(out, "{}_{}".format(suite, name), "summary.json")
    if name in tables[suite] and os.path.exists(src):
      fam = pipeline.read_summary(src).get("per_family")
      if not fam:
        return None
      return render_families("{} ({})".format(
          label.split(" ")[0], POLICY_LABELS.get(name, name)), fam)
  return None


def publish(out: Optional[str] = None, *,
            horizon: Optional[int] = None) -> str:
  """Writes ``OUT/results/`` (module docstring); returns the path of its
  ``RESULTS.md``."""
  k = pipeline.knobs(out=out, horizon=horizon)
  results = os.path.join(k.out, "results")
  tables = merge_tables(k.out, results)
  for suite, _ in SUITES:
    for name in ORDER:
      src = os.path.join(k.out, "{}_{}".format(suite, name), "summary.json")
      if os.path.exists(src):
        shutil.copy(src, os.path.join(results,
                                      "{}_{}.json".format(suite, name)))

  path = os.path.join(results, "RESULTS.md")
  with open(path, "w") as fp:
    fp.write(render(tables, k.out, horizon=k.horizon))
  print("wrote", path)
  return path


def main() -> None:
  publish()


if __name__ == "__main__":
  main()
