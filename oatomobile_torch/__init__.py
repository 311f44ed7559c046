"""`oatomobile_torch`: the PyTorch/CUDA port of `oatomobile_tpu`.

The JAX package beside it stays the reference: every module here keeps
the name of its JAX counterpart and is held against it by the tests
(``tests/test_torch_*.py``).  This package imports torch and numpy only,
never jax or anything of ``oatomobile_tpu``.

Entry points (``envs.batched.BatchedEnv``, ``envs.carla.CARLANavEnv`` and
the ``"carla"`` simulator under it, ``benchmarks.batched_eval.
evaluate_batched``, ``sim.make_params``, ``sim.init_scene_batch``,
``python -m oatomobile_torch.bench``, ``python -m oatomobile_torch.entry``)
run on ``device="cuda"`` unless the caller passes ``device="cpu"``.

The public names are those of the JAX package's ``__init__`` (the core
API of the reference), minus its compilation cache.
"""

__version__ = "0.1.0"

from oatomobile_torch import types
from oatomobile_torch.core.agent import Agent
from oatomobile_torch.core.benchmark import Benchmark
from oatomobile_torch.core.dataset import Dataset, Episode, tokens
from oatomobile_torch.core.loop import EnvironmentLoop
from oatomobile_torch.core.registry import registry
from oatomobile_torch.core.rl import (Env, FiniteHorizonWrapper,
                                      LiveViewWrapper, Metric,
                                      MonitorWrapper, ReturnsMetric,
                                      SaveToDiskWrapper, StepsMetric,
                                      Transition, Wrapper)
from oatomobile_torch.core.simulator import (Action, Observations, Sensor,
                                             SensorSuite, SensorTypes,
                                             Simulator)

__all__ = (
    "Agent",
    "Benchmark",
    "Dataset",
    "EnvironmentLoop",
    "Episode",
    "tokens",
    "registry",
    "Env",
    "Wrapper",
    "FiniteHorizonWrapper",
    "Metric",
    "LiveViewWrapper",
    "MonitorWrapper",
    "ReturnsMetric",
    "StepsMetric",
    "SaveToDiskWrapper",
    "Transition",
    "Action",
    "Observations",
    "Sensor",
    "SensorSuite",
    "SensorTypes",
    "Simulator",
)
