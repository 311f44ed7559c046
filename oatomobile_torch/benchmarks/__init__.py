"""The benchmark suites (CARNOVEL, CoRL2017) and the batched evaluator:
the port of the JAX package's ``benchmarks``."""

from oatomobile_torch.benchmarks.carnovel.benchmark import carnovel
from oatomobile_torch.benchmarks.corl2017.benchmark import corl2017

__all__ = ["carnovel", "corl2017"]
