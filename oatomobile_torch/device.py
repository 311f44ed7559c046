"""Device selection for the port's entry points.

The port is written for an NVIDIA GPU: entry points default to
``device="cuda"`` and refuse to run silently on the CPU.  A caller that
wants the CPU (the tests) says so with ``device="cpu"``.
"""

import torch


def resolve(device="cuda") -> torch.device:
  """Returns ``device`` as a ``torch.device``; raises when it names CUDA
  and no card is present."""
  device = torch.device(device)
  if device.type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError(
        "oatomobile_torch runs on a CUDA device by default and none is "
        "available; pass device='cpu' to run on the CPU.")
  return device
