"""Benchmark evaluation CLI: port of the JAX package's
``benchmarks/run.py``.

Evaluates an agent on CARNOVEL or CoRL2017 through the single-scene API
(``Benchmark.evaluate``), writing a metrics.csv per task.

Run:  python -m oatomobile_torch.benchmarks.run \\
          --benchmark carnovel --agent autopilot --log_dir /tmp/eval \\
          [--subtasks AbnormalTurns] [--device cuda | --cpu]

``--agent autopilot|blind`` run.  ``dim``, ``cil`` and ``rip`` need their
``.flax`` checkpoints, and the port has no loader for them yet (the
checkpoint utilities come with training): they raise
``NotImplementedError``.
"""

import argparse
import functools

_NO_CHECKPOINT_LOADER = (
    "--agent {} needs a .flax checkpoint, and oatomobile_torch has no "
    "checkpoint loader yet (utils/checkpoint.py comes with training)")


def make_agent_fn(args):
  if args.agent == "autopilot":
    from oatomobile_torch.baselines.rulebased import AutopilotAgent  # pylint: disable=import-outside-toplevel
    return functools.partial(AutopilotAgent, noise=args.noise)
  if args.agent == "blind":
    from oatomobile_torch.baselines.rulebased import BlindAgent  # pylint: disable=import-outside-toplevel
    return BlindAgent
  if args.agent in ("dim", "cil", "rip"):
    raise NotImplementedError(_NO_CHECKPOINT_LOADER.format(args.agent))
  raise ValueError("unknown agent {}".format(args.agent))


def main(argv=None) -> None:
  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument("--benchmark", choices=("carnovel", "corl2017"),
                      default="carnovel")
  parser.add_argument("--agent",
                      choices=("autopilot", "blind", "dim", "cil", "rip"),
                      default="autopilot")
  parser.add_argument("--log_dir", required=True)
  parser.add_argument("--subtasks", default=None)
  parser.add_argument("--noise", type=float, default=0.0)
  parser.add_argument("--ckpt", default=None)
  parser.add_argument("--ckpts", nargs="*", default=None)
  parser.add_argument("--algorithm", default="WCM",
                      choices=("WCM", "MA", "BCM"))
  parser.add_argument("--monitor", action="store_true")
  parser.add_argument("--device", default="cuda",
                      help="where the scenes live (default: cuda)")
  parser.add_argument("--cpu", action="store_true",
                      help="run on the CPU (same as --device cpu)")
  args = parser.parse_args(argv)
  device = "cpu" if args.cpu else args.device

  agent_fn = make_agent_fn(args)
  if args.benchmark == "carnovel":
    from oatomobile_torch.benchmarks.carnovel.benchmark import CARNOVEL  # pylint: disable=import-outside-toplevel
    bench = CARNOVEL(device=device)
  else:
    from oatomobile_torch.benchmarks.corl2017.benchmark import CORL2017  # pylint: disable=import-outside-toplevel
    bench = CORL2017(device=device)

  bench.evaluate(
      agent_fn,
      log_dir=args.log_dir,
      monitor=args.monitor,
      subtasks_id=args.subtasks,
  )


if __name__ == "__main__":
  main()
