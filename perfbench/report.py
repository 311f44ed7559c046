"""A run's result and the lines it prints."""

import dataclasses
import subprocess
import sys
from typing import Any, Callable, Dict, List, Optional

from perfbench.check import Check, failed


@dataclasses.dataclass
class Result:
  """What a driver hands back: the end-to-end metrics' values, what the
  per-layer readers read (``context``), the device's numbers, the trace's
  breakdown, the checks and the run's own counts (``notes``)."""
  attempted: int
  end_to_end: Dict[str, float] = dataclasses.field(default_factory=dict)
  context: Dict[str, Any] = dataclasses.field(default_factory=dict)
  device: Dict[str, Any] = dataclasses.field(default_factory=dict)
  breakdown: Optional[Dict[str, list]] = None
  checks: List[Check] = dataclasses.field(default_factory=list)
  notes: Dict[str, Any] = dataclasses.field(default_factory=dict)


def card() -> Dict[str, str]:
  """The card's name and power limit as ``nvidia-smi`` reads them."""
  import torch  # pylint: disable=import-outside-toplevel
  out = {"kind": torch.cuda.get_device_name(0), "power_limit": "unknown"}
  try:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30, check=True)
    out["power_limit"] = smi.stdout.strip().splitlines()[0]
  except (OSError, subprocess.SubprocessError, IndexError):
    pass
  return out


def result_line(cell, result: Result, trace: bool,
                readers: Callable[[str], Any]) -> Dict[str, Any]:
  """The JSON object of the run's last line.  With ``trace`` the metrics
  are the cell's per-layer metrics, each read by its reader from the
  run's ``context`` (a reader that finds nothing returns None and its
  metric is left out); else the cell's end-to-end metrics."""
  metrics = {}
  if trace:
    for m in cell["per_layer"]:
      value = readers(m["name"]).read(result.context)
      if value is not None:
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
  else:
    for m in cell["end_to_end"]:
      metrics[m["name"]] = {"value": result.end_to_end[m["name"]],
                            "unit": m["unit"]}
  info = card()
  print("perfbench: cell {} on {} (power limit {}): {}".format(
      cell["name"], info["kind"], info["power_limit"],
      ", ".join("{} {}".format(k, v) for k, v in result.notes.items())),
        file=sys.stderr)
  line = {
      "correct": failed(result.checks) == 0,
      "attempted": result.attempted,
      "failed": failed(result.checks),
      "metrics": metrics,
      "device": dict({"platform": "gpu", "kind": info["kind"]},
                     **result.device),
  }
  line["notes"] = dict(result.notes, power_limit=info["power_limit"])
  if trace and result.breakdown is not None:
    line["breakdown"] = result.breakdown
  line["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                    for c in result.checks}
  return line


def check_lines(result: Result) -> List[str]:
  return ["check {}: {} (limit {}) {}".format(
      c.name, c.value, c.limit, "ok" if c.ok else "FAILED")
          for c in result.checks]
