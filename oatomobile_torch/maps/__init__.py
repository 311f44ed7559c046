"""Map assets: procedural towns, waypoint graphs, rasters, routing."""

from oatomobile_torch.maps.assets import MAX_NEXT, TownMap
from oatomobile_torch.maps.routing import (graph_csr, nearest_waypoint,
                                         plan_route, plan_route_batch,
                                         route_distances, shortest_route)
from oatomobile_torch.maps.towns import AVAILABLE_TOWNS, load_town, town_bounds

__all__ = [
    "MAX_NEXT",
    "TownMap",
    "AVAILABLE_TOWNS",
    "load_town",
    "town_bounds",
    "nearest_waypoint",
    "plan_route",
    "route_distances",
    "shortest_route",
    "graph_csr",
    "plan_route_batch",
]
