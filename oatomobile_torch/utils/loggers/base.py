"""Logger base class and no-op logger."""

import abc
from typing import Any, Mapping

LoggingData = Mapping[str, Any]


class Logger(abc.ABC):
  """A logger has a `write` method."""

  @abc.abstractmethod
  def write(self, data: LoggingData) -> None:
    """Writes `data` to destination (file, terminal, database, etc.)."""

  def close(self) -> None:
    """Flushes and releases any resources."""


class NoOpLogger(Logger):
  """Logger that does nothing."""

  def write(self, data: LoggingData) -> None:
    pass
