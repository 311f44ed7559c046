"""CSV logger."""

import csv
import os
import time
from typing import Optional, TextIO

from oatomobile_torch.utils.loggers import base


class CSVLogger(base.Logger):
  """Logs scalar data to a CSV file; columns fixed by the first write."""

  def __init__(self,
               directory: str = "logs",
               label: Optional[str] = None) -> None:
    os.makedirs(directory, exist_ok=True)
    label = label or "logs"
    self._fname = os.path.join(directory, "{}_{}.csv".format(
        label, int(time.time())))
    self._file: Optional[TextIO] = None
    self._writer: Optional[csv.DictWriter] = None

  @property
  def file_path(self) -> str:
    return self._fname

  def write(self, data: base.LoggingData) -> None:
    if self._writer is None:
      self._file = open(self._fname, "w", newline="")
      self._writer = csv.DictWriter(self._file, fieldnames=sorted(data.keys()))
      self._writer.writeheader()
    self._writer.writerow({k: data.get(k) for k in self._writer.fieldnames})
    self._file.flush()

  def close(self) -> None:
    if self._file is not None:
      self._file.close()
