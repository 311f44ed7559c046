"""The plain reference that decides ``correct``: plain PyTorch and NumPy,
eager, importing nothing of the program (``oatomobile_torch``) and taking
nothing it made.

Most modules are frozen copies of the program's plain modules of the same
path (their docstrings still name the JAX package they were ported from):
the maps and town build, the world model and autopilot, the DIM model,
policy and bridge, the trainer's loss.  Worked out anew here: the route
search (``maps/routing.py``), the Threefry draws (``threefry.py``), the
splat (``splat.py``, the kernel's plain arithmetic), the rollout step and
its auto-reset (``rollout.py``), and the trainer's batches and Adam
(``train.py``).  A later change to the program does not move them.
"""
