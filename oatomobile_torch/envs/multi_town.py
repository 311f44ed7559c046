"""Multi-town batched environments (Town01-05 in one logical batch): the
port of the JAX package's ``envs/multi_town.py``.

Map assets differ per town (array shapes included), so each town gets its
own ``BatchedEnv``; this wrapper splits the logical batch across them and
merges observations and rollout statistics along the scene axis.
"""

from typing import Dict, Sequence, Tuple

import torch

from oatomobile_torch.envs.batched import BatchedEnv
from oatomobile_torch.maps.towns import AVAILABLE_TOWNS
from oatomobile_torch.sensors import synth


class MultiTownBatchedEnv:
  """A batch of scenes distributed over several towns."""

  def __init__(
      self,
      towns: Sequence[str] = AVAILABLE_TOWNS,
      batch_size: int = 1024,
      sensors: Sequence[str] = synth.STATE_SENSORS,
      num_vehicles: int = 0,
      num_pedestrians: int = 0,
      seed: int = 0,
      **env_kwargs,
  ) -> None:
    """``env_kwargs`` go to every town's ``BatchedEnv`` (``device`` among
    them: ``"cuda"`` unless the caller asks for ``"cpu"``)."""
    if batch_size % len(towns):
      raise ValueError("batch_size {} does not divide evenly across {} "
                       "towns".format(batch_size, len(towns)))
    per_town = batch_size // len(towns)
    self._towns = list(towns)
    self._envs = [
        BatchedEnv(town, per_town, sensors=sensors,
                   num_vehicles=num_vehicles,
                   num_pedestrians=num_pedestrians, seed=seed + 1000 * i,
                   **env_kwargs)
        for i, town in enumerate(towns)
    ]
    self._batch_size = batch_size

  @property
  def batch_size(self) -> int:
    return self._batch_size

  @property
  def towns(self) -> Sequence[str]:
    return self._towns

  @property
  def envs(self) -> Sequence[BatchedEnv]:
    return self._envs

  def reset(self) -> Dict[str, torch.Tensor]:
    obs = [env.reset() for env in self._envs]
    return {key: torch.cat([o[key] for o in obs]) for key in obs[0]}

  def step(self, actions) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    actions = torch.as_tensor(actions, dtype=torch.float32,
                              device=self._envs[0].device)
    per = self._envs[0].batch_size
    all_obs, all_done = [], []
    for i, env in enumerate(self._envs):
      obs, done = env.step(actions[i * per:(i + 1) * per])
      all_obs.append(obs)
      all_done.append(done)
    merged = {key: torch.cat([o[key] for o in all_obs])
              for key in all_obs[0]}
    return merged, torch.cat(all_done)

  def rollout(self, num_steps: int, policy=None, collect: Sequence[str] = (),
              compute: Sequence[str] = ()):
    """Per-town rollouts; merged (finals list, collected dict, stats)."""
    finals, collected_all, stats_all = [], [], []
    for env in self._envs:
      final, collected, stats = env.rollout(num_steps, policy=policy,
                                            collect=collect,
                                            compute=compute)
      finals.append(final)
      collected_all.append(collected)
      stats_all.append(stats)
    stats = {key: torch.cat([s[key] for s in stats_all])
             for key in stats_all[0]}
    merged_collected = ()
    if collect:
      merged_collected = {
          key: torch.cat([c[key] for c in collected_all], dim=1)
          for key in collected_all[0]
      }
    return finals, merged_collected, stats
