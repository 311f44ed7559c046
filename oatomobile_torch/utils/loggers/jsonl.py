"""JSONL logger (machine-readable training curves)."""

import json
import os
import time
from typing import Optional

from oatomobile_torch.utils.loggers import base


class JSONLLogger(base.Logger):
  """Appends one JSON object per `write` to a .jsonl file."""

  def __init__(self,
               directory: str = "logs",
               label: Optional[str] = None) -> None:
    os.makedirs(directory, exist_ok=True)
    label = label or "logs"
    self._fname = os.path.join(directory, "{}.jsonl".format(label))
    self._file = open(self._fname, "a")

  @property
  def file_path(self) -> str:
    return self._fname

  def write(self, data: base.LoggingData) -> None:
    record = {"_time": time.time()}
    for key, value in data.items():
      try:
        json.dumps(value)
        record[key] = value
      except TypeError:
        record[key] = str(value)
    self._file.write(json.dumps(record) + "\n")
    self._file.flush()

  def close(self) -> None:
    self._file.close()
