"""Runs the autopilot agent closed-loop in a CARLAEnv.

Run:  python -m oatomobile_torch.baselines.rulebased.autopilot.run \\
          --town Town01 --num_steps 200 [--monitor_fname run.gif] [--cpu]
"""

import argparse

from oatomobile_torch.baselines.rulebased.autopilot.agent import \
    AutopilotAgent
from oatomobile_torch.core.loop import EnvironmentLoop
from oatomobile_torch.core.rl import (FiniteHorizonWrapper, LiveViewWrapper,
                                      MonitorWrapper, ReturnsMetric,
                                      SaveToDiskWrapper, StepsMetric)
from oatomobile_torch.envs.carla import (CARLAEnv, CollisionsMetric,
                                         DistanceMetric, LaneInvasionsMetric)


def main() -> None:
  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument("--town", default="Town01")
  parser.add_argument("--num_steps", type=int, default=200)
  parser.add_argument("--num_vehicles", type=int, default=10)
  parser.add_argument("--num_pedestrians", type=int, default=0)
  parser.add_argument("--noise", type=float, default=0.1)
  parser.add_argument("--output_dir", default=None,
                      help="if set, saves observations to disk")
  parser.add_argument("--monitor_fname", default=None,
                      help="if set, records a GIF of the episode")
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
      sensors=("goal", "velocity", "lidar"),
      device="cpu" if args.cpu else "cuda",
  )
  if args.output_dir is not None:
    env = SaveToDiskWrapper(env, output_dir=args.output_dir)
  env = FiniteHorizonWrapper(env, max_episode_steps=args.num_steps)
  if args.monitor_fname is not None:
    env = MonitorWrapper(env, output_fname=args.monitor_fname)
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
      agent_fn=lambda environment: AutopilotAgent(environment,
                                                  noise=args.noise),
      environment=env,
      metrics=metrics,
  ).run()
  print(results)


if __name__ == "__main__":
  main()
