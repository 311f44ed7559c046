"""Benchmark evaluation CLI: port of the JAX package's
``benchmarks/run.py``.

Evaluates an agent on CARNOVEL or CoRL2017 through the single-scene API
(``Benchmark.evaluate``), writing a metrics.csv per task.

Run:  python -m oatomobile_torch.benchmarks.run \\
          --benchmark carnovel --agent autopilot --log_dir /tmp/eval \\
          [--subtasks AbnormalTurns] [--ckpt ... | --ckpts a b c d] \\
          [--device cuda | --cpu]

``--agent dim|cil`` load one checkpoint (``--ckpt``), ``--agent rip`` one
DIM checkpoint per member (``--ckpts``): the port's ``.pt`` files (a
``state_dict``, e.g. ``ckpts/model-best.pt`` of the trainers) or the JAX
package's ``.flax`` files (read without flax, converted by
``models.convert``).  The models take the trainers' and the JAX CLI's
shapes: DIM ``(4, 2)``, CIL ``(40, 2)``.
"""

import argparse
import functools


def device_of(args) -> str:
  return "cpu" if getattr(args, "cpu", False) else args.device


def _load_dim(ckpt_path: str, device):
  """An ``ImitativeModel((4, 2))`` on ``device`` with the weights of a
  ``.pt`` or ``.flax`` checkpoint."""
  from oatomobile_torch.models.dim import ImitativeModel  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.utils.checkpoint import read_params  # pylint: disable=import-outside-toplevel
  return read_params(ckpt_path, ImitativeModel(output_shape=(4, 2),
                                               device=device))


def make_agent_fn(args):
  if args.agent == "autopilot":
    from oatomobile_torch.baselines.rulebased import AutopilotAgent  # pylint: disable=import-outside-toplevel
    return functools.partial(AutopilotAgent, noise=args.noise)
  if args.agent == "blind":
    from oatomobile_torch.baselines.rulebased import BlindAgent  # pylint: disable=import-outside-toplevel
    return BlindAgent
  flag, value = (("--ckpts", args.ckpts) if args.agent == "rip" else
                 ("--ckpt", args.ckpt))
  if not value:
    raise ValueError("--agent {} needs a checkpoint: {} PATH (.pt or "
                     ".flax)".format(args.agent, flag))
  device = device_of(args)
  if args.agent == "dim":
    from oatomobile_torch.baselines.learned.dim import DIMAgent  # pylint: disable=import-outside-toplevel
    return functools.partial(DIMAgent, model=_load_dim(args.ckpt, device))
  if args.agent == "cil":
    # pylint: disable=import-outside-toplevel
    from oatomobile_torch.baselines.learned.cil import (BehaviouralModel,
                                                        CILAgent)
    from oatomobile_torch.utils.checkpoint import read_params
    model = read_params(args.ckpt, BehaviouralModel(output_shape=(40, 2),
                                                    device=device))
    return functools.partial(CILAgent, model=model)
  if args.agent == "rip":
    from oatomobile_torch.baselines.learned.rip import RIPAgent  # pylint: disable=import-outside-toplevel
    return functools.partial(RIPAgent, algorithm=args.algorithm,
                             models=[_load_dim(c, device)
                                     for c in args.ckpts])
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
  device = device_of(args)

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
