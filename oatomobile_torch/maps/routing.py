"""Host-side route planning over the waypoint graph.

Replaces the reference's per-call A* ``global_plan``
(upstream oatomobile/utils/carla.py:703-744, backed by CARLA's
``GlobalRoutePlanner``) with a breadth-first shortest-hop search over the
directed waypoint graph.  Edges are ~uniform length (WAYPOINT_SPACING), so
BFS hop count ~ metric shortest path.  Routes are computed once per episode
on the host and shipped to the device as a fixed-capacity index array —
route *following* is then pure gathers inside the compiled step.
"""

import weakref
from collections import deque
from typing import Optional, Tuple

import numpy as np

from oatomobile_torch.maps.assets import TownMap

# id(town) -> (indptr, indices).  TownMap is unhashable (a dataclass with
# eq=True), so the key is its id; a finalizer drops the entry when the
# town dies, before CPython can hand its address to another town.
_CSR_CACHE = {}


def build_graph_csr(town: TownMap) -> Tuple[np.ndarray, np.ndarray]:
  """CSR (indptr, indices) of the waypoint successor graph, built anew."""
  counts = town.wp_num_next.astype(np.int64)
  indptr = np.zeros(town.num_waypoints + 1, dtype=np.int32)
  np.cumsum(counts, out=indptr[1:])
  indices = np.empty(int(indptr[-1]), dtype=np.int32)
  for u in range(town.num_waypoints):
    indices[indptr[u]:indptr[u + 1]] = town.wp_next[u, :counts[u]]
  return indptr, indices


def graph_csr(town: TownMap) -> Tuple[np.ndarray, np.ndarray]:
  """CSR (indptr, indices) view of the waypoint successor graph, cached
  for as long as ``town`` lives."""
  key = id(town)
  if key not in _CSR_CACHE:
    _CSR_CACHE[key] = build_graph_csr(town)
    weakref.finalize(town, _CSR_CACHE.pop, key, None)
  return _CSR_CACHE[key]


def plan_route_batch(town: TownMap, origin_wps: np.ndarray,
                     dest_wps: np.ndarray,
                     capacity: int) -> Tuple[np.ndarray, np.ndarray]:
  """Plans many routes at once: native C++ BFS when available
  (oatomobile_torch/native), Python BFS otherwise.

  Returns (routes [Q, capacity] i32 saturating-padded, lengths [Q] i32).
  Raises ValueError when the graph is not ``town``'s or a waypoint id is
  not one of its waypoints.
  """
  from oatomobile_torch import native
  W = town.num_waypoints
  indptr, indices = graph_csr(town)
  if len(indptr) - 1 != W:
    raise ValueError("route graph of {} nodes for {} with {} waypoints"
                     .format(len(indptr) - 1, town.name, W))
  for what, wps in (("origin", origin_wps), ("destination", dest_wps)):
    wps = np.asarray(wps)
    if wps.size and (wps.min() < 0 or wps.max() >= W):
      raise ValueError("{} waypoint outside [0, {}) in {}".format(
          what, W, town.name))
  result = native.plan_routes_native(indptr, indices,
                                     np.asarray(origin_wps, np.int32),
                                     np.asarray(dest_wps, np.int32),
                                     capacity)
  if result is not None:
    return result
  routes = np.empty((len(origin_wps), capacity), dtype=np.int32)
  lengths = np.empty((len(origin_wps),), dtype=np.int32)
  for q, (o, d) in enumerate(zip(origin_wps, dest_wps)):
    path = shortest_route(town, int(o), int(d))
    if path is None:
      path = np.asarray([int(o)], dtype=np.int32)
    path = path[:capacity]
    lengths[q] = len(path)
    routes[q, :len(path)] = path
    routes[q, len(path):] = path[-1]
  return routes, lengths


def shortest_route(town: TownMap, origin_wp: int,
                   destination_wp: int) -> Optional[np.ndarray]:
  """Returns waypoint ids along the shortest path origin -> destination,
  inclusive of both endpoints, or None if unreachable."""
  if origin_wp == destination_wp:
    return np.asarray([origin_wp], dtype=np.int32)
  W = town.num_waypoints
  parent = np.full(W, -1, dtype=np.int64)
  parent[origin_wp] = origin_wp
  frontier = deque([int(origin_wp)])
  nxt = town.wp_next
  nnum = town.wp_num_next
  while frontier:
    u = frontier.popleft()
    for k in range(nnum[u]):
      v = int(nxt[u, k])
      if parent[v] < 0:
        parent[v] = u
        if v == destination_wp:
          # Reconstruct.
          path = [v]
          while path[-1] != origin_wp:
            path.append(int(parent[path[-1]]))
          return np.asarray(path[::-1], dtype=np.int32)
        frontier.append(v)
  return None


def nearest_waypoint(town: TownMap, xy: np.ndarray) -> int:
  """Nearest waypoint id via the precomputed raster (O(1))."""
  idx = town.world_to_pixel(np.asarray(xy, dtype=np.float32))
  return int(town.nearest_wp[idx[0], idx[1]])


def plan_route(town: TownMap,
               origin_xy: np.ndarray,
               destination_xy: np.ndarray,
               capacity: int) -> Tuple[np.ndarray, int]:
  """Plans a route and pads it to ``capacity`` (device-friendly).

  Returns:
    route: [capacity] int32 waypoint ids; positions past the route end are
      padded with the destination waypoint (so route following saturates).
    length: the true route length.
  """
  o = nearest_waypoint(town, origin_xy)
  d = nearest_waypoint(town, destination_xy)
  path = shortest_route(town, o, d)
  if path is None:
    # Disconnected (should not happen in closed grid towns): stay in place.
    path = np.asarray([o], dtype=np.int32)
  if len(path) > capacity:
    path = path[:capacity]
  out = np.full(capacity, path[-1], dtype=np.int32)
  out[:len(path)] = path
  return out, int(len(path))


def route_distances(town: TownMap, route: np.ndarray,
                    length: int) -> np.ndarray:
  """Cumulative metric distance along a route (parity with the reference's
  ``global_plan`` third return value, utils/carla.py:736-743)."""
  pts = town.wp_xy[route[:length]]
  deltas = np.linalg.norm(np.diff(pts, axis=0), axis=1)
  return np.concatenate([[0.0], np.cumsum(deltas)]).astype(np.float32)
