"""Benchmark API, a named task suite and its evaluation loop: a copy of
the JAX package's ``core/benchmark.py`` (task registry, ``load`` with a
finite horizon, ``evaluate`` looping tasks through ``EnvironmentLoop`` and
writing a ``metrics.csv`` per task)."""

import abc
import functools
import logging
import os
from typing import Any, Callable, Mapping, Optional, Sequence

from oatomobile_torch.core.agent import Agent
from oatomobile_torch.core.loop import EnvironmentLoop
from oatomobile_torch.core.rl import (Env, FiniteHorizonWrapper, Metric,
                                    MonitorWrapper)

logger = logging.getLogger(__name__)


class Benchmark(abc.ABC):
  """An abstract benchmark: tasks + metrics + evaluation loop."""

  @property
  @abc.abstractmethod
  def metrics(self) -> Sequence[Metric]:
    """Returns the list of metrics associated with the benchmark."""

  @property
  @abc.abstractmethod
  def tasks(self) -> Mapping[str, Callable[..., Env]]:
    """Returns the mapping of task id -> env factory."""

  def load(self,
           task_id: str,
           max_episode_steps: Optional[int] = None,
           *args: Any,
           **kwargs: Any) -> Env:
    """Loads a task by id, optionally capping the horizon."""
    if task_id not in self.tasks:
      raise ValueError("Unrecognised task with id {}".format(task_id))
    env = self.tasks[task_id](*args, **kwargs)
    if max_episode_steps is not None:
      env = FiniteHorizonWrapper(env, max_episode_steps=max_episode_steps)
    return env

  def evaluate(self,
               agent_fn: Callable[..., Agent],
               log_dir: str,
               render: bool = False,
               monitor: bool = False,
               subtasks_id: Optional[str] = None,
               *args: Any,
               **kwargs: Any) -> None:
    """Runs a full evaluation of an agent on the benchmark.

    Writes one ``metrics.csv`` per task under ``log_dir/<task_id>/``.
    """
    os.makedirs(log_dir, exist_ok=True)
    tasks = self.tasks if subtasks_id is None else [
        task for task in self.tasks if subtasks_id in task
    ]

    for task_id in tasks:
      logger.info("Start evaluation on task %s", task_id)
      task_dir = os.path.join(log_dir, task_id)
      os.makedirs(task_dir, exist_ok=True)

      env = self.load(task_id)
      if monitor:
        video_fname = os.path.join(task_dir, "video.gif")
        env = MonitorWrapper(env, output_fname=video_fname)

      results = EnvironmentLoop(
          agent_fn=functools.partial(agent_fn, *args, **kwargs),
          environment=env,
          metrics=self.metrics,
          render_mode="human" if render else "none",
      ).run()

      # Dumps results in a CSV file (header + one row), like the reference.
      keys = list(results.keys())
      with open(os.path.join(task_dir, "metrics.csv"), "w") as fp:
        fp.write(",".join(keys) + "\n")
        fp.write(",".join(str(results[key]) for key in keys) + "\n")
