"""Core abstractions: simulator/rl/agent/loop/dataset/benchmark/registry
(framework-free copies of the JAX package's ``core/``)."""
