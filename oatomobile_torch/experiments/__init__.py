"""The research pipeline: the port of the JAX package's experiment
scripts (``scripts/``), each runnable as ``python -m
oatomobile_torch.experiments.<name>`` (``--cpu`` for the CPU).

- ``pipeline``: a Town01 collection mix, merged; RIP and CIL trained;
  the CARNOVEL and CoRL2017 tables of the batched policies
  (``scripts/experiment_r4.py``);
- ``round5``: the round-5 defaults on top of ``pipeline``
  (``scripts/experiment_r5.py``);
- ``round3``: the round-3 defaults on top of ``pipeline``
  (``scripts/experiment_r3.py``);
- ``round2``: the round-2 pipeline, RIP alone on a 200x200 pack and the
  CARNOVEL agent comparison (``scripts/experiment_r2.py``), and
  ``post_round2``: RIP-BCM, the CoRL2017 autopilot row, the flow profile
  and the bench after it (``scripts/post_experiment.py``);
- ``train_in_the_loop``: collect, train DIM (resumed), evaluate, for
  several rounds (``scripts/train_in_the_loop.py``);
- ``eval_carnovel_agents``: the autopilot, DIM and RIP-WCM/MA on CARNOVEL
  from the newest ensemble epoch (``scripts/eval_carnovel_agents.py``);
- ``headtohead``: RIP-WCM against DIM at 20 episodes a task
  (``scripts/headtohead_r5.py``);
- ``publish``: ``RESULTS.md`` from the tables
  (``scripts/post_experiment_r5.py``), written under the run's output
  directory only; ``publish_r3`` and ``publish_r4`` the round-3 and
  round-4 renderings (``scripts/post_experiment_r3.py``,
  ``post_experiment_r4.py``);
- ``rip_sweep``: RIP's aggregations and plan-step budgets on one ensemble
  (``scripts/eval_rip_sweep.py``);
- ``train_dim_full``: the scaled DIM run (``scripts/train_dim_full.py``);
- ``study_dim50``: DIM at a 50x50 input (``scripts/study_dim50.py``);
- ``demo_full_loop`` and ``demo_dashboard``: collect, train and drive;
  a dashboard GIF (``scripts/demo_full_loop.py``, ``demo_dashboard.py``);
- ``profile_flow``: the DIM plan's split (``scripts/profile_flow.py``);
- ``diag``: the ``scripts/diag_*.py`` forensics.

Every experiment writes under its output directory (``RUN_OUT``,
``LOOP_OUT``, ``DEMO_OUT`` or an ``--out`` flag) and nowhere else.
"""
