"""Unique token generation for episodes and samples (a copy of the JAX
package's ``utils/uuid.py``)."""

import uuid
from typing import Generator


def unique_token_generator() -> Generator[str, None, None]:
  """Yields random hex tokens, one per call to ``next``."""
  while True:
    yield uuid.uuid4().hex
