"""CoRL2017: the original CARLA driving benchmark task suite.  Port of the
JAX package's ``benchmarks/corl2017/benchmark.py``: 150 JSON navigation
tasks (Town01/Town02 x Straight/Turn/FullTown x 25), horizon 1500,
terminate-on-collision, three metrics.  The task configs are copied
verbatim.
"""

import functools
import glob
import json
import os
from typing import Callable, Mapping, Sequence

from oatomobile_torch.core.benchmark import Benchmark
from oatomobile_torch.core.rl import Metric, StepsMetric
from oatomobile_torch.envs.carla import (CARLANavEnv, CollisionsMetric,
                                         LaneInvasionsMetric,
                                         TerminateOnCollisionWrapper)

_configs = glob.glob(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                 "*.json"))
_TASKS = {}
for _config in _configs:
  _task_id = os.path.basename(_config).replace(".json", "")
  with open(_config, "r") as _fp:
    _TASKS[_task_id] = json.load(_fp)


class CORL2017(Benchmark):
  """The CoRL2017 benchmark; its tasks' environments live on ``device``
  (``"cuda"`` unless the caller asks for ``"cpu"``; resolved when a task
  is loaded)."""

  def __init__(self, device="cuda") -> None:
    self.device = device

  def load(self, task_id: str, **kwargs) -> CARLANavEnv:
    env = super().load(task_id, max_episode_steps=1500, **kwargs)
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
    return [StepsMetric(), CollisionsMetric(), LaneInvasionsMetric()]


corl2017 = CORL2017()
