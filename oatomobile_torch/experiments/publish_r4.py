"""Renders a round-4 run's results: ``RESULTS.md`` from its tables.
Port of the JAX package's ``scripts/post_experiment_r4.py``.

    python -m oatomobile_torch.experiments.publish_r4

Reads ``RUN_OUT/tables*.json`` (``pipeline``, round 4) and writes
``RUN_OUT/results_r4/``: the merged ``tables.json``, the RIP and CIL
training logs, every ``<suite>_<policy>`` summary and ``RESULTS.md``, the
round's header paragraph then the CARNOVEL and CoRL2017 agent tables in
``publish.ORDER``, each with the per-family table of RIP-WCM, DIM or the
autopilot.  It writes nothing outside the run's output directory: the
JAX script also wrote into the repository's ``docs/results_r4`` and
patched ``README.md``'s results block, which stay the JAX rounds'
records.  Knob: RUN_OUT (``pipeline``'s default).
"""

import os
import shutil
from typing import Optional

from oatomobile_torch.experiments import pipeline, publish

HEADER = ("All numbers measured at the HEAD commit with the batched "
          "on-device evaluator (`benchmarks/batched_eval.py`): CARNOVEL "
          "10 episodes/task, CoRL2017 3 episodes/task, fresh traffic per "
          "episode, 95% binomial CIs.  Learned agents trained on "
          "HEAD-expert data with a benchmark-density traffic mix "
          "(scripts/experiment_r4.py).\n")


def render(tables, out: str) -> str:
  """The text of ``RESULTS.md`` for ``tables``."""
  md = ["# Round-4 agent results\n", HEADER]
  for suite, label in publish.SUITES:
    if suite in tables:
      md.append(publish.render_table(label, tables[suite]))
      panel = publish.family_panel(tables, out, suite, label)
      if panel:
        md.append(panel)
  return "\n".join(md)


def publish_r4(out: Optional[str] = None) -> str:
  """Writes ``OUT/results_r4/`` (module docstring); returns the path of
  its ``RESULTS.md``."""
  out = pipeline.knobs(out=out).out
  results = os.path.join(out, "results_r4")
  tables = publish.merge_tables(out, results)
  for suite, _ in publish.SUITES:
    for name in publish.ORDER:
      src = os.path.join(out, "{}_{}".format(suite, name), "summary.json")
      if os.path.exists(src):
        shutil.copy(src, os.path.join(results,
                                      "{}_{}.json".format(suite, name)))
  path = os.path.join(results, "RESULTS.md")
  with open(path, "w") as fp:
    fp.write(render(tables, out))
  print("wrote", path)
  return path


def main() -> None:
  publish_r4()


if __name__ == "__main__":
  main()
