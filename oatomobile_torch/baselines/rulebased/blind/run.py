"""Runs the blind agent closed-loop in a CARLAEnv.

Run:  python -m oatomobile_torch.baselines.rulebased.blind.run \\
          --town Town01 [--live] [--cpu]
"""

import argparse

from oatomobile_torch.baselines.rulebased.blind.agent import BlindAgent
from oatomobile_torch.core.loop import EnvironmentLoop
from oatomobile_torch.core.rl import (FiniteHorizonWrapper, LiveViewWrapper,
                                      ReturnsMetric, StepsMetric)
from oatomobile_torch.envs.carla import (CARLAEnv, CollisionsMetric,
                                         DistanceMetric, LaneInvasionsMetric)


def main() -> None:
  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument("--town", default="Town01")
  parser.add_argument("--num_steps", type=int, default=200)
  parser.add_argument("--num_vehicles", type=int, default=0)
  parser.add_argument("--num_pedestrians", type=int, default=0)
  parser.add_argument("--live", action="store_true",
                      help="show the multi-sensor dashboard live (~5 Hz) "
                           "while the episode runs")
  parser.add_argument("--cpu", action="store_true",
                      help="run the scene on the CPU (default: the card)")
  args = parser.parse_args()

  env = CARLAEnv(
      town=args.town,
      num_vehicles=args.num_vehicles,
      num_pedestrians=args.num_pedestrians,
      sensors=("goal", "velocity"),
      device="cpu" if args.cpu else "cuda",
  )
  env = FiniteHorizonWrapper(env, max_episode_steps=args.num_steps)
  if args.live:
    env = LiveViewWrapper(env)
  metrics = [
      StepsMetric(),
      ReturnsMetric(),
      CollisionsMetric(),
      LaneInvasionsMetric(),
      DistanceMetric(),
  ]
  results = EnvironmentLoop(
      agent_fn=BlindAgent,
      environment=env,
      metrics=metrics,
  ).run()
  print(results)


if __name__ == "__main__":
  main()
