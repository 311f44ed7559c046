"""Records a dashboard GIF of a CARNOVEL episode.  Port of the JAX
package's ``scripts/demo_dashboard.py``.

    python -m oatomobile_torch.experiments.demo_dashboard [--cpu]
        [--task Roundabouts0-v0] [--steps 300] [--out FILE.gif] [--every 4]

The human-facing rendering demo: the front camera, the bird view, the
LIDAR splat and the state HUD each recorded frame, written by
``MonitorWrapper`` with the ``AutopilotAgent`` driving.  Writing the GIF
needs imageio (the card's machine has none: there it raises before the
episode).
"""

import argparse
import importlib.util
import os
import tempfile


def run(task: str = "Roundabouts0-v0", steps: int = 300, out: str = None,
        every: int = 4, device="cuda") -> str:
  """Records the episode into ``out`` (default: ``dashboard.gif`` under
  the system's temporary directory); returns its path."""
  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.baselines.rulebased.autopilot.agent import (
      AutopilotAgent)
  from oatomobile_torch.benchmarks.carnovel.benchmark import CARNOVEL
  from oatomobile_torch.core.loop import EnvironmentLoop
  from oatomobile_torch.core.rl import MonitorWrapper

  if importlib.util.find_spec("imageio") is None:
    raise RuntimeError("the dashboard GIF needs imageio, which is not "
                       "installed here")
  if out is None:
    out = os.path.join(tempfile.gettempdir(), "dashboard.gif")
  env = CARNOVEL(device=device).load(task, max_episode_steps=steps)
  env = MonitorWrapper(env, output_fname=out, render_mode="human",
                       record_every=every)
  EnvironmentLoop(agent_fn=AutopilotAgent, environment=env).run()
  return out


def main(argv=None) -> None:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--task", default="Roundabouts0-v0")
  parser.add_argument("--steps", type=int, default=300)
  parser.add_argument("--out", default=None,
                      help="default: dashboard.gif under the system's "
                      "temporary directory")
  parser.add_argument("--every", type=int, default=4,
                      help="record every Nth frame (20 Hz sim -> 5 Hz gif)")
  parser.add_argument("--cpu", action="store_true",
                      help="run on the CPU (default: the CUDA card)")
  args = parser.parse_args(argv)
  out = run(args.task, args.steps, args.out, args.every,
            "cpu" if args.cpu else "cuda")
  print("wrote", out, os.path.getsize(out), "bytes")


if __name__ == "__main__":
  main()
