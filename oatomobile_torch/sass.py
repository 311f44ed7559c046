"""Loops in the SASS of a built kernel library, for the record of what the
compiler made of a kernel's inner loop.

    python -m oatomobile_torch.sass build/oatomobile_torch/kernels/libbev_splat.so

Runs ``cuobjdump -sass`` (CUDA toolkit) on the library and prints, for
every kernel, its instruction count and each loop (a backward branch and
the instructions from its target to it): the loop's instructions, its
FMUL count and, counting four FMULs to a BEV splat inside-test, the
instructions per test.  Innermost loops (no other loop inside) are marked.
"""

import collections
import os
import re
import shutil
import subprocess
import sys

_FUNCTION = re.compile(r"^\s*Function\s*:\s*(\S+)")
_INSTRUCTION = re.compile(
    r"^\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)(.*?);")
_TARGET = re.compile(r"0x([0-9a-f]+)")

Loop = collections.namedtuple(
    "Loop", "start end instructions fmul tests_per_iteration innermost")


def _cuobjdump() -> str:
  found = shutil.which("cuobjdump")
  if found:
    return found
  default = "/usr/local/cuda/bin/cuobjdump"
  if os.path.exists(default):
    return default
  raise RuntimeError("cuobjdump not found (CUDA toolkit)")


def disassemble(library: str) -> str:
  return subprocess.run([_cuobjdump(), "-sass", library], capture_output=True,
                        text=True, check=True).stdout


def parse(sass: str) -> dict:
  """{kernel name: [(address, opcode, operands)]} from cuobjdump output."""
  kernels, current = {}, None
  for line in sass.splitlines():
    match = _FUNCTION.match(line)
    if match:
      current = kernels.setdefault(match.group(1), [])
      continue
    match = _INSTRUCTION.match(line)
    if match and current is not None:
      current.append((int(match.group(1), 16), match.group(2),
                      match.group(3)))
  return kernels


def loops(instructions) -> list:
  """Every backward branch of one kernel as a Loop."""
  found = []
  for address, opcode, operands in instructions:
    if not opcode.startswith("BRA"):
      continue
    target = _TARGET.search(operands)
    if target is None or int(target.group(1), 16) > address:
      continue
    start = int(target.group(1), 16)
    body = [op for a, op, _ in instructions if start <= a <= address]
    fmul = sum(op.startswith("FMUL") for op in body)
    found.append([start, address, len(body), fmul, fmul / 4.0])
  out = []
  for start, end, count, fmul, tests in found:
    inner = not any(s >= start and e <= end and (s, e) != (start, end)
                    for s, e, *_ in found)
    out.append(Loop(start, end, count, fmul, tests, inner))
  return out


def report(library: str) -> list:
  """Lines describing each kernel of ``library`` and its loops."""
  lines = []
  for name, instructions in parse(disassemble(library)).items():
    lines.append("sass {}: {} instructions".format(name, len(instructions)))
    for loop in loops(instructions):
      per_test = (" = {:.1f} per test".format(
          loop.instructions / loop.tests_per_iteration)
                  if loop.tests_per_iteration else "")
      lines.append(
          "  loop 0x{:04x}-0x{:04x}{}: {} instructions, {} FMUL "
          "({:g} tests){}".format(loop.start, loop.end,
                                  " (innermost)" if loop.innermost else "",
                                  loop.instructions, loop.fmul,
                                  loop.tests_per_iteration, per_test))
  return lines


if __name__ == "__main__":
  for path in sys.argv[1:]:
    print("\n".join(report(path)))
