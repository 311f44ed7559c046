"""The benchmark of ``oatomobile_torch`` on CUDA cards: one run of one
cell.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Each run is a fresh process: it sets up the cell from its files (see
``registry``), warms the cell's own shapes, measures for ``--seconds``,
checks what the timed path produced against the plain reference under
``perfbench/reference``, and prints one JSON line last on standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics), ``device`` and, with
``--trace 1``, ``breakdown``; then ``checks``, each number compared with
its limit, which standard error also ends with.

``--control`` puts the reference computed in the configuration's next
lower precision in the program's place (the check must then fail); it is
for measuring the limits, not for the driver's runs.

Without a CUDA card, or with fewer cards than the cell asks for, the run
exits with code 1 and prints no result.
"""

import time

PROCESS_START = time.perf_counter()

# pylint: disable=wrong-import-position
import argparse
import json
import os
import sys

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "oatomobile_tpu")


def cache_dirs(root: str) -> dict:
  """Build and kernel caches of the program, at fixed paths inside the
  checkout, so that only a checkout's first run builds."""
  build = os.path.join(root, "build")
  return {
      "OATOMOBILE_TORCH_BUILD_DIR": os.path.join(build, "oatomobile_torch"),
      "TORCH_EXTENSIONS_DIR": os.path.join(build, "torch_extensions"),
      "TRITON_CACHE_DIR": os.path.join(build, "triton"),
  }


def forbidden_loaded() -> list:
  """Modules of JAX or of the JAX package in this process, compared by
  whole top-level names."""
  tops = {name.split(".", 1)[0] for name in list(sys.modules)}
  return sorted(tops & set(FORBIDDEN_MODULES))


def fail(message: str) -> None:
  print("perfbench: " + message, file=sys.stderr)
  sys.exit(1)


def main(argv=None) -> None:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--workload", required=True)
  parser.add_argument("--seed", type=int, required=True)
  parser.add_argument("--seconds", type=float, required=True)
  parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
  parser.add_argument("--control", action="store_true")
  args = parser.parse_args(argv)

  from perfbench import registry  # pylint: disable=import-outside-toplevel
  for key, value in cache_dirs(registry.ROOT).items():
    os.environ[key] = value
  # Libraries that would load JAX on their own (transformers) do not.
  os.environ["USE_FLAX"] = "0"

  bench = registry.benchmark()
  cell = registry.cell(args.workload, bench)
  import torch  # pylint: disable=import-outside-toplevel
  if not torch.cuda.is_available():
    fail("no CUDA device: the benchmark measures the card and has no CPU "
         "fallback")
  if torch.cuda.device_count() < cell["entry"]["chips"]:
    fail("cell {} asks for {} cards, {} present".format(
        cell["name"], cell["entry"]["chips"], torch.cuda.device_count()))
  try:
    import oatomobile_torch  # pylint: disable=import-outside-toplevel,unused-import
  except ImportError as e:
    fail("the program (oatomobile_torch) is not in this checkout: {}".format(
        e))

  drive = registry.driver(cell["traffic"]["driver"])
  result = drive.run(cell, seed=args.seed, seconds=args.seconds,
                     trace=bool(args.trace), control=args.control,
                     device="cuda", process_start=PROCESS_START)
  found = forbidden_loaded()
  if found:
    fail("the run loaded {}: the benchmark measures the PyTorch port "
         "alone".format(", ".join(found)))
  from perfbench import report  # pylint: disable=import-outside-toplevel
  line = report.result_line(cell, result, trace=bool(args.trace),
                            readers=registry.reader)
  for text in report.check_lines(result):
    print(text, file=sys.stderr)
  print(json.dumps(line))


if __name__ == "__main__":
  main()
