"""Benchmark route-feasibility repair: no task may be unwinnable.

The pin solver (maps/pins.py) aligns benchmark (origin, destination)
spawn indices with family geometry, but shared-index constraints let a
few pairs land on one-way detours: the destination sits 30 m away
across the street while the directed lane graph forces a 500 m block
wrap.  At the reference cruise of 20 km/h (defaults.py:185) a
1500-step/50 ms horizon (carnovel & corl2017 benchmark.py) covers at
most ~416 m, so such routes are lost before the first control tick —
round 2 tolerated up to 5% of them ("index-collision stragglers"),
which made the benchmark a bug tracker.

This pass runs once at town build time, after pinning: while any
benchmark route's BFS length falls outside ``[low, high]``, swap one of
the violating pair's spawn slots with a *benchmark-unused* slot that
brings every route through that index into band, preferring the
geometrically closest candidate (family semantics — a Turn stays a
short hooked route — are preserved by minimal displacement).  All
candidate evaluations are batched through the native BFS planner, so a
full repair costs a few tens of milliseconds.
"""

from typing import List

import numpy as np

from perfbench.reference.maps.assets import TownMap
from perfbench.reference.maps.routing import plan_route_batch

ROUTE_LOW = 60.0    # m; shorter routes end inside the 7.5 m arrival radius
ROUTE_HIGH = 390.0  # m; 1500 steps @ 20 km/h covers ~416 m — keep margin


def _route_lengths(town: TownMap, spawn_wp: np.ndarray,
                   pairs: np.ndarray, capacity: int = 2048) -> np.ndarray:
  """Metric BFS route length for each (origin_slot, dest_slot) pair."""
  routes, lens = plan_route_batch(town, spawn_wp[pairs[:, 0]],
                                  spawn_wp[pairs[:, 1]], capacity)
  out = np.zeros(len(pairs))
  for q in range(len(pairs)):
    pts = town.wp_xy[routes[q, :max(int(lens[q]), 1)]]
    out[q] = np.linalg.norm(np.diff(pts, axis=0), axis=1).sum()
  return out


def repair_benchmark_routes(
    town: TownMap,
    tasks: List[dict],
    low: float = ROUTE_LOW,
    high: float = ROUTE_HIGH,
    max_swaps: int = 64,
) -> TownMap:
  """Returns a town whose benchmark routes all have length in [low, high].

  ``tasks`` are config dicts with ``origin``/``destination`` spawn
  indices (taken modulo the spawn count, as everywhere else).  Raises if
  a violation cannot be repaired — an unwinnable benchmark task is a
  build error, not a warning.
  """
  if not tasks:
    return town
  S = town.num_spawn_points
  spawn_wp = town.spawn_wp.copy()
  spawn_edge = (town.spawn_edge.copy()
                if town.spawn_edge is not None else None)
  pairs = np.asarray([[t["origin"] % S, t["destination"] % S]
                      for t in tasks], dtype=np.int64)
  used = np.zeros(S, dtype=bool)
  used[pairs.reshape(-1)] = True
  free = np.flatnonzero(~used)

  def tasks_using(slot: int) -> np.ndarray:
    return np.flatnonzero((pairs == slot).any(axis=1))

  for _ in range(max_swaps):
    lengths = _route_lengths(town, spawn_wp, pairs)
    bad = np.flatnonzero((lengths < low) | (lengths > high))
    if len(bad) == 0:
      break
    worst = bad[np.argmax(np.abs(lengths[bad] - np.clip(
        lengths[bad], low, high)))]
    o_slot, d_slot = pairs[worst]
    # Try the endpoint shared by fewer tasks first: smaller blast radius.
    endpoints = sorted((int(d_slot), int(o_slot)),
                       key=lambda s: len(tasks_using(s)))
    swapped = False
    for slot in endpoints:
      affected = tasks_using(slot)
      # Evaluate every free candidate against every affected task in one
      # batched BFS call.
      cand_pairs = []
      for c in free:
        for t in affected:
          p = pairs[t].copy()
          p[p == slot] = -1  # marker
          cand_pairs.append(np.where(p == -1, c, p))
      cand_pairs = np.asarray(cand_pairs).reshape(len(free),
                                                  len(affected), 2)
      cand_lengths = _route_lengths(
          town, spawn_wp, cand_pairs.reshape(-1, 2)).reshape(
              len(free), len(affected))
      ok = ((cand_lengths >= low) & (cand_lengths <= high)).all(axis=1)
      if not ok.any():
        continue
      # Minimal displacement keeps the task family's geometry.
      disp = np.linalg.norm(
          town.wp_xy[spawn_wp[free]] - town.wp_xy[spawn_wp[slot]][None],
          axis=1)
      disp[~ok] = np.inf
      c = int(free[np.argmin(disp)])
      for arr in (spawn_wp,) + ((spawn_edge,)
                                if spawn_edge is not None else ()):
        arr[[slot, c]] = arr[[c, slot]]
      swapped = True
      break
    if not swapped:
      raise ValueError(
          "Cannot repair benchmark route {}m for pair {} in {}".format(
              lengths[worst], pairs[worst], town.name))
  else:
    lengths = _route_lengths(town, spawn_wp, pairs)
    bad = np.flatnonzero((lengths < low) | (lengths > high))
    if len(bad):
      raise ValueError("Route repair did not converge for {}: {} left"
                       .format(town.name, len(bad)))

  import dataclasses
  return dataclasses.replace(town, spawn_wp=spawn_wp,
                             spawn_edge=spawn_edge)
