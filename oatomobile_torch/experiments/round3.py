"""The round-3 learned-agent experiment: the whole pipeline (collect ->
train CIL and RIP -> the CARNOVEL and CoRL2017 tables) with the round-3
defaults.  Port of the JAX package's ``scripts/experiment_r3.py``.

    python -m oatomobile_torch.experiments.round3 [--cpu]

The JAX script is ``scripts/experiment_r4.py`` with another collection
mix (``[[0, 640], [8, 1280], [24, 640]]``: up to 24 vehicles, none at
the benchmarks' density), another output directory and the log tag
``r3``; so this module runs ``pipeline``'s phases and knobs with those
defaults.  A knob set in the environment wins over them.  Publish with
``python -m oatomobile_torch.experiments.publish_r3``.
"""

import os

from oatomobile_torch.experiments import pipeline

DEFAULTS = {
    "RUN_OUT": pipeline.default_out("r3"),
    "RUN_MIX": "[[0, 640], [8, 1280], [24, 640]]",
}
TAG = "r3"


def knobs(**overrides) -> pipeline.Knobs:
  """``pipeline.knobs`` with round 3's defaults."""
  return pipeline.knobs(defaults=DEFAULTS, **overrides)


def main(argv=None) -> None:
  for name, value in DEFAULTS.items():
    os.environ.setdefault(name, value)
  with pipeline.log_tag(TAG):
    pipeline.main(argv)


if __name__ == "__main__":
  main()
