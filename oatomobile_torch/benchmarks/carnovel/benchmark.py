"""CARNOVEL: the novel-scene distribution-shift benchmark.  Port of the JAX
package's ``benchmarks/carnovel/benchmark.py``: 27 JSON navigation tasks
(AbnormalTurns / BusyTown / Hills / Roundabouts) over Town03-04, horizon
1500, terminate-on-collision, five metrics.  The task configs are copied
verbatim (they are data, not code).
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

  def plot_benchmark(self, output_dir: str) -> None:
    """Draws each task's route over its town's road raster, one PNG per
    task in ``output_dir`` (host-side: matplotlib and the route
    planner)."""
    import matplotlib  # pylint: disable=import-outside-toplevel
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt  # pylint: disable=import-outside-toplevel
    import numpy as np  # pylint: disable=import-outside-toplevel
    from oatomobile_torch.maps import load_town, plan_route  # pylint: disable=import-outside-toplevel

    os.makedirs(output_dir, exist_ok=True)
    for task_id, config in _TASKS.items():
      town = load_town(config["town"])
      o_loc, _ = town.spawn_transform(config["origin"])
      d_loc, _ = town.spawn_transform(config["destination"])
      route, length = plan_route(town, o_loc[:2], d_loc[:2], capacity=4096)
      pts = town.wp_xy[route[:length]]

      fig, ax = plt.subplots(figsize=(8.0, 8.0))
      ax.imshow(town.road_mask.T, origin="lower", cmap="gray",
                extent=(town.raster_origin[0],
                        town.raster_origin[0] +
                        town.road_mask.shape[0] / town.raster_ppm,
                        town.raster_origin[1],
                        town.raster_origin[1] +
                        town.road_mask.shape[1] / town.raster_ppm))
      ax.scatter(pts[:, 0], pts[:, 1], c=np.linspace(0, 1, length),
                 cmap="RdYlBu_r", s=4)
      ax.set(title=task_id, frame_on=False)
      ax.get_xaxis().set_visible(False)
      ax.get_yaxis().set_visible(False)
      fig.savefig(os.path.join(output_dir, "{}.png".format(task_id)),
                  bbox_inches="tight", pad_inches=0)
      plt.close(fig)


carnovel = CARNOVEL()
