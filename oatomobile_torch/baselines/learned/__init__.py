"""Learned in-loop policies (DIM, RIP, CIL) and their plan -> control
bridge: the port of the JAX package's ``baselines/learned``."""
