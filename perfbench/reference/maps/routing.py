"""Route planning of the reference: breadth-first search over the directed
waypoint graph, in plain Python and NumPy.

The program plans its routes with a native C++ search.  This module works
them out again from the same graph (``wp_next``/``wp_num_next``): one
full search from each distinct origin, which marks each waypoint when it
is first reached and remembers the waypoint it was reached from, scanning
successors in their table order.  A search that stops at the destination
gives every waypoint it reached the same parent, so the routes agree with
any search that follows those rules.
"""

from typing import Dict, List, Tuple

import numpy as np

from perfbench.reference.maps.assets import TownMap


# (graph bytes, origin) -> parents: a town's repair and its scene batch
# plan many routes from the same origins over one graph.
_TREES: Dict[Tuple[bytes, int], List[int]] = {}


def _successors(town: TownMap) -> Tuple[bytes, List[List[int]]]:
  key = (town.wp_next.tobytes() + town.wp_num_next.tobytes())
  nxt = town.wp_next.tolist()
  return key, [row[:n] for row, n in zip(nxt, town.wp_num_next.tolist())]


def _tree(key: bytes, succ: List[List[int]], origin: int) -> List[int]:
  if (key, origin) in _TREES:
    return _TREES[(key, origin)]
  parent = [-1] * len(succ)
  parent[origin] = origin
  queue = [origin]
  for u in queue:  # the list grows while it is read: a FIFO queue
    for v in succ[u]:
      if parent[v] < 0:
        parent[v] = u
        queue.append(v)
  _TREES[(key, origin)] = parent
  return parent


def _path(parent: List[int], origin: int, dest: int) -> np.ndarray:
  if origin == dest or parent[dest] < 0:
    return np.asarray([origin], dtype=np.int32)
  path = [dest]
  while path[-1] != origin:
    path.append(int(parent[path[-1]]))
  return np.asarray(path[::-1], dtype=np.int32)


def plan_route_batch(town: TownMap, origin_wps: np.ndarray,
                     dest_wps: np.ndarray,
                     capacity: int) -> Tuple[np.ndarray, np.ndarray]:
  """(routes [Q, capacity] i32 padded with their last waypoint, lengths [Q]
  i32); an unreachable destination gives the one-point route [origin]."""
  origin_wps = np.asarray(origin_wps, np.int64)
  dest_wps = np.asarray(dest_wps, np.int64)
  W = town.num_waypoints
  for what, wps in (("origin", origin_wps), ("destination", dest_wps)):
    if wps.size and (wps.min() < 0 or wps.max() >= W):
      raise ValueError("{} waypoint outside [0, {}) in {}".format(
          what, W, town.name))
  key, succ = _successors(town)
  routes = np.empty((len(origin_wps), capacity), dtype=np.int32)
  lengths = np.empty((len(origin_wps),), dtype=np.int32)
  for q, (o, d) in enumerate(zip(origin_wps.tolist(), dest_wps.tolist())):
    path = _path(_tree(key, succ, o), o, d)[:capacity]
    lengths[q] = len(path)
    routes[q, :len(path)] = path
    routes[q, len(path):] = path[-1]
  return routes, lengths

