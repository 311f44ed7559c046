"""CARNOVEL: the novel-scene distribution-shift benchmark.  Port of the JAX
package's ``benchmarks/carnovel/benchmark.py``: 27 JSON navigation tasks
(AbnormalTurns / BusyTown / Hills / Roundabouts) over Town03-04, horizon
1500, terminate-on-collision, five metrics.  The task configs are copied
verbatim (they are data, not code).

``plot_benchmark`` (matplotlib) is not ported yet.
"""

import functools
import glob
import json
import os
from typing import Callable, Mapping, Sequence

from oatomobile_torch.core.benchmark import Benchmark
from oatomobile_torch.core.rl import Metric, ReturnsMetric, StepsMetric
from oatomobile_torch.envs.carla import (CARLANavEnv, CollisionsMetric,
                                         DistanceMetric, LaneInvasionsMetric,
                                         TerminateOnCollisionWrapper)

_configs = glob.glob(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                 "*.json"))
_TASKS = {}
for _config in _configs:
  _task_id = os.path.basename(_config).replace(".json", "")
  with open(_config, "r") as _fp:
    _TASKS[_task_id] = json.load(_fp)


class CARNOVEL(Benchmark):
  """The CARNOVEL benchmark; its tasks' environments live on ``device``
  (``"cuda"`` unless the caller asks for ``"cpu"``; resolved when a task
  is loaded)."""

  def __init__(self, device="cuda") -> None:
    self.device = device

  def load(self, task_id: str, **kwargs) -> CARLANavEnv:
    # CARNOVEL horizon: 1500 steps; callers may override (e.g. short demo
    # episodes).
    kwargs.setdefault("max_episode_steps", 1500)
    env = super().load(task_id, **kwargs)
    env = TerminateOnCollisionWrapper(env)
    return env

  @property
  def tasks(self) -> Mapping[str, Callable[..., CARLANavEnv]]:
    return {
        task_id: functools.partial(CARLANavEnv, device=self.device, **config)
        for (task_id, config) in _TASKS.items()
    }

  @property
  def metrics(self) -> Sequence[Metric]:
    return [
        StepsMetric(),
        CollisionsMetric(),
        LaneInvasionsMetric(),
        DistanceMetric(),
        ReturnsMetric(),
    ]


carnovel = CARNOVEL()
