"""The diagnostics: the port of the JAX package's ``scripts/diag_*.py``,
each runnable as ``python -m oatomobile_torch.experiments.diag.<name>``
with the JAX script's flags (``--cpu`` for the CPU).

- ``hero_stops``: the hero's stopped time by cause (``diag_hero_stops``);
- ``stalls``: the NPC stall census (``diag_stalls``);
- ``town02``: CoRL2017 Town02 outcomes and timeouts (``diag_town02``);
- ``busytown``: CARNOVEL BusyTown timeouts by the autopilot's own hazard
  tests (``diag_busytown``);
- ``hills``: CARNOVEL Hills crashes in four buckets (``diag_hills``);
- ``learned_failures``: a learned policy's failure taxonomy
  (``diag_learned_failures``);
- ``busytown_viz`` and ``hills_viz``: the timeouts' end scenes and the
  crash scenes, drawn with matplotlib on the host from the rollout's
  snapshots (``diag_busytown_viz``, ``diag_hills_viz``).

Every rollout is ``common.run``: one captured step a step on a card.
"""
