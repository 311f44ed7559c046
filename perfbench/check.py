"""The comparison that decides ``correct``: what the timed path produced
against what the plain reference works out from the same inputs.

Each number compared has a limit of its own, in the cell's traffic file
(``limits``), set from readings of sound runs (the lower) and of the
control (the upper): ``PERF.md`` gives both for every limit.
"""

import dataclasses
from typing import Dict, List

import torch


@dataclasses.dataclass
class Check:
  name: str
  value: float
  limit: float

  @property
  def ok(self) -> bool:
    return self.value <= self.limit


def mismatches(got: Dict[str, torch.Tensor],
               want: Dict[str, torch.Tensor]) -> int:
  """Elements that differ, over every leaf (floats compared exactly)."""
  if set(got) != set(want):
    raise ValueError("leaves differ: {}".format(set(got) ^ set(want)))
  return int(sum(int((got[k].cpu() != want[k].cpu()).sum()) for k in got))


def state_gap(got: Dict[str, torch.Tensor],
              want: Dict[str, torch.Tensor]) -> float:
  """The worst leaf's gap.  A float leaf's is its largest |got - want|
  over its own largest |want|, or a thousandth of the median float
  leaf's where that is larger (a leaf that is all but zero is not judged
  on its rounding), inf where a value is finite on one side only.  An integer or flag leaf (counters,
  route positions, keys, done and collision flags) is exact: its gap is 1
  where any element differs, else 0."""
  if set(got) != set(want):
    raise ValueError("leaves differ: {}".format(set(got) ^ set(want)))
  got = {k: v.cpu() for k, v in got.items()}
  want = {k: v.cpu() for k, v in want.items()}
  floats = [k for k in want if want[k].is_floating_point() and
            want[k].numel()]
  scales = {k: float(want[k].double().abs().max()) for k in floats}
  median = sorted(scales.values())[len(floats) // 2] if floats else 0.0
  worst = 0.0
  for k, w in want.items():
    g = got[k]
    if g.shape != w.shape:
      return float("inf")
    if k not in scales:
      if not torch.equal(g.to(w.dtype), w):
        worst = max(worst, 1.0)
      continue
    g, w = g.double(), w.double()
    if bool((torch.isfinite(g) != torch.isfinite(w)).any()):
      return float("inf")
    both = torch.isfinite(g) & torch.isfinite(w)
    gap = float((g - w)[both].abs().max()) if bool(both.any()) else 0.0
    worst = max(worst, gap / max(scales[k], 1e-3 * median, 1e-30))
  return worst


def failed(checks: List[Check]) -> int:
  return sum(not c.ok for c in checks)
