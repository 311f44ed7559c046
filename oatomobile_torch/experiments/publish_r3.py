"""Renders a round-3 run's results: ``RESULTS.md`` from its tables.
Port of the JAX package's ``scripts/post_experiment_r3.py``.

    python -m oatomobile_torch.experiments.publish_r3

Reads ``RUN_OUT/tables*.json`` (``round3``) and writes
``RUN_OUT/results_r3/``: the merged ``tables.json``, the RIP and CIL
training logs, the summaries of the six headline rows (CARNOVEL RIP-WCM
and CIL, CoRL2017 autopilot, CIL, DIM and RIP-WCM) and ``RESULTS.md``,
the CARNOVEL (shift) and CoRL2017 (in-distribution) agent tables, their
rows in the order the evaluation wrote them, each with the per-family
table of RIP-WCM, DIM or the autopilot.  It writes nothing outside the
run's output directory (the JAX script wrote into the repository's
``docs/results_r3``).  Knob: RUN_OUT (``round3``'s default).
"""

import os
import shutil
from typing import Optional

from oatomobile_torch.experiments import publish, round3

HEADLINE = ("carnovel_rip_wcm", "carnovel_cil", "corl2017_autopilot",
            "corl2017_cil", "corl2017_dim", "corl2017_rip_wcm")


def render(tables, out: str) -> str:
  """The text of ``RESULTS.md`` for ``tables``."""
  md = ["# Round-3 agent results\n"]
  for suite, label in publish.SUITES:
    if suite in tables:
      md.append(publish.render_table(label, tables[suite], order=None))
      panel = publish.family_panel(tables, out, suite, label)
      if panel:
        md.append(panel)
  return "\n".join(md)


def publish_r3(out: Optional[str] = None) -> str:
  """Writes ``OUT/results_r3/`` (module docstring); returns the path of
  its ``RESULTS.md``."""
  out = round3.knobs(out=out).out
  results = os.path.join(out, "results_r3")
  tables = publish.merge_tables(out, results)
  for key in HEADLINE:
    src = os.path.join(out, key, "summary.json")
    if os.path.exists(src):
      shutil.copy(src, os.path.join(results, key + ".json"))
  text = render(tables, out)
  path = os.path.join(results, "RESULTS.md")
  with open(path, "w") as fp:
    fp.write(text)
  print("wrote", path)
  print(text)
  return path


def main() -> None:
  publish_r3()


if __name__ == "__main__":
  main()
