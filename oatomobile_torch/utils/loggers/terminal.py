"""Terminal logger."""

import time
from typing import Callable

from oatomobile_torch.utils.loggers import base


def _format_value(value) -> str:
  if isinstance(value, float):
    return "{:.3f}".format(value)
  return str(value)


def serialize(values: base.LoggingData) -> str:
  return " | ".join("{} = {}".format(k, _format_value(v))
                    for k, v in sorted(values.items()))


class TerminalLogger(base.Logger):
  """Logs to terminal, rate-limited by `time_delta` seconds."""

  def __init__(self,
               label: str = "",
               time_delta: float = 0.0,
               print_fn: Callable[[str], None] = print) -> None:
    self._label = label and "[{}] ".format(label)
    self._time_delta = time_delta
    self._print_fn = print_fn
    self._time = 0.0

  def write(self, values: base.LoggingData) -> None:
    now = time.time()
    if (now - self._time) > self._time_delta:
      self._print_fn("{}{}".format(self._label, serialize(values)))
      self._time = now
