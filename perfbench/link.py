"""Bringing the card's host link to its working state before a window.

On the H100 machines this benchmark runs on, a process's captured steps
first run each device operation ~0.34 us slower, until, after 1 to more
than 30 seconds, they switch once to the fast speed; bulk copies between
host and card before the window bring the fast speed at once in most runs
(``PERF.md``, PR 15).  The copies are set-up: ``setup_s`` counts them.
"""

import time

import torch

BURST_BYTES = 256 * 2**20


def warm(seconds: float, device) -> int:
  """Enqueues copies of a pinned host buffer to the card and back for
  ``seconds`` of host time, then waits for them: the stream holds about a
  thousand, so the card copies for ~13 s in all (nothing off a card).

  Returns the program's peak of allocated device bytes before the copies,
  and restarts the count, so that the copies' buffer is not read as the
  program's (the run's peak is the larger of the two counts)."""
  if torch.device(device).type != "cuda":
    return 0
  peak = torch.cuda.max_memory_allocated()
  host = torch.empty(BURST_BYTES, dtype=torch.uint8, pin_memory=True)
  card = torch.empty_like(host, device=device)
  start = time.perf_counter()
  while time.perf_counter() - start < seconds:
    card.copy_(host, non_blocking=True)
    host.copy_(card, non_blocking=True)
  torch.cuda.synchronize()
  del card
  torch.cuda.reset_peak_memory_stats()
  return peak
