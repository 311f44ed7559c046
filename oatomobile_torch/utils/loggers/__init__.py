"""Acme-style loggers: a copy of the JAX package's ``utils/loggers``
(Logger ABC, NoOp, Terminal, CSV, JSONL).  ``TensorBoardLogger`` and
``WandBLogger`` are factories that import their backends only when called.
"""

from oatomobile_torch.utils.loggers.base import Logger, LoggingData, NoOpLogger
from oatomobile_torch.utils.loggers.csv import CSVLogger
from oatomobile_torch.utils.loggers.jsonl import JSONLLogger
from oatomobile_torch.utils.loggers.terminal import TerminalLogger

__all__ = [
    "Logger",
    "LoggingData",
    "NoOpLogger",
    "CSVLogger",
    "JSONLLogger",
    "TensorBoardLogger",
    "TerminalLogger",
    "WandBLogger",
]


def TensorBoardLogger(*args, **kwargs):  # noqa: N802 (lazy factory)
  """Returns a TensorBoard-backed logger (scalars + image summaries,
  reference torch/loggers.py:37-141); import-gated on tensorboard."""
  from oatomobile_torch.utils.loggers.tensorboard import (
      TensorBoardLogger as _TBLogger)
  return _TBLogger(*args, **kwargs)


def WandBLogger(*args, **kwargs):  # noqa: N802 (factory keeping the ref name)
  """Returns a wandb-backed logger; raises ImportError if wandb is absent."""
  from oatomobile_torch.utils.loggers.wandb import WandBLogger as _WandBLogger
  return _WandBLogger(*args, **kwargs)
