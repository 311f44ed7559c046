"""The round-5 learned-agent experiment: the whole pipeline (collect ->
train -> CARNOVEL/CoRL2017 tables) with the round-5 defaults.  Port of
the JAX package's ``scripts/experiment_r5.py``.

    python -m oatomobile_torch.experiments.round5 [--cpu]

On top of ``pipeline`` (whose phases and knobs it reuses): 30 training
epochs, and the headline agents first in the evaluation order
(autopilot, RIP-WCM, DIM, CIL), so that a partial run still gives those
rows.  The trainers oversample stopped -> restart transitions 3x (their
default).  A knob set in the environment wins over these defaults.
Publish with ``python -m oatomobile_torch.experiments.publish``.
"""

import os

from oatomobile_torch.experiments import pipeline

DEFAULTS = {
    "RUN_OUT": pipeline.default_out("r5"),
    "RUN_EPOCHS": "30",
    "RUN_POLICIES": "autopilot,rip_wcm,dim,cil,rip_ma,rip_bcm",
    "RUN_CORL_POLICIES": "autopilot,rip_wcm,dim,cil",
}


def main(argv=None) -> None:
  for name, value in DEFAULTS.items():
    os.environ.setdefault(name, value)
  pipeline.main(argv)


if __name__ == "__main__":
  main()
