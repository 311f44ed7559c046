"""TensorBoard logger: scalars + trajectory-overlay image summaries.

A generic `Logger` (usable by any trainer): scalars from the record dict,
and an explicit `write_images` for image panels.
"""

from typing import Mapping, Optional

import numpy as np

from oatomobile_torch.utils.loggers.base import Logger, LoggingData


class TensorBoardLogger(Logger):
  """Writes scalar records (and optional image grids) to TensorBoard."""

  def __init__(self, log_dir: str, label: str = "train",
               step_key: str = "epoch") -> None:
    # torch's SummaryWriter needs the tensorboard package: imported here,
    # so the loggers import without it.
    from torch.utils.tensorboard import SummaryWriter
    self._writer = SummaryWriter(log_dir=log_dir)
    self._label = label
    self._step_key = step_key
    self._auto_step = 0

  def write(self, data: LoggingData) -> None:
    step = int(data.get(self._step_key, self._auto_step))
    self._auto_step = step + 1
    for key, value in data.items():
      if key == self._step_key:
        continue
      try:
        scalar = float(value)
      except (TypeError, ValueError):
        continue
      self._writer.add_scalar("{}/{}".format(self._label, key), scalar,
                              global_step=step)
    self._writer.flush()

  def write_images(self, images: Mapping[str, np.ndarray],
                   step: Optional[int] = None) -> None:
    """Writes [H, W, 3] images (e.g. plan-over-BEV panels)."""
    step = self._auto_step if step is None else int(step)
    for key, image in images.items():
      image = np.asarray(image)
      if image.dtype != np.uint8:
        image = (np.clip(image, 0.0, 1.0) * 255).astype(np.uint8)
      self._writer.add_image("{}/{}".format(self._label, key), image,
                             global_step=step, dataformats="HWC")
    self._writer.flush()

  def close(self) -> None:
    self._writer.close()
