"""Town definitions and cached loading.

The five towns mirror the reference's available set
(upstream oatomobile/simulators/carla/defaults.py:176-182) in
relative scale AND in geometric character: Town01/Town02 are small grid
training towns; Town03-05 carry the distribution-shift geometry CARNOVEL's
task families are named for — Town03 has a roundabout, a switchback
serpentine ("hills" in 2-D), a 45-degree diagonal avenue and a sharp-V
junction; Town04 is the big busy town with a curved diagonal arterial;
Town05 mixes a grid with a roundabout and curved bypass.

Spawn indices are pinned per benchmark task (maps/pins.py) so e.g.
Roundabouts*-v0 routes really traverse the ring.  Each town provides more
spawn points than the maximum config index (Town01=256, Town02=256,
Town03=257, Town04=365).
"""

import functools
import os
from typing import Tuple

import numpy as np

from oatomobile_torch import paths
from oatomobile_torch.maps import pins as pins_lib
from oatomobile_torch.maps.assets import TownMap
from oatomobile_torch.maps.builder import (EdgeSpec, NetworkSpec,
                                         apply_spawn_pins, build_town,
                                         grid_spec)

AVAILABLE_TOWNS = ("Town01", "Town02", "Town03", "Town04", "Town05")

# Grid street coordinates (vertical xs, horizontal ys).  Slightly irregular
# spacings give each town a distinct geometry.
_GRIDS = {
    "Town01": (
        (0.0, 88.0, 172.0, 264.0, 352.0),
        (0.0, 80.0, 164.0, 244.0, 330.0),
    ),
    "Town02": (
        (0.0, 72.0, 140.0, 204.0),
        (0.0, 64.0, 132.0, 196.0),
    ),
    "Town03": (
        (0.0, 84.0, 172.0),
        (0.0, 76.0, 150.0, 228.0),
    ),
    "Town04": (
        (0.0, 92.0, 180.0, 272.0, 356.0, 448.0, 540.0),
        (0.0, 84.0, 168.0, 256.0, 340.0, 428.0, 512.0),
    ),
    "Town05": (
        (0.0, 80.0, 156.0, 240.0, 320.0, 400.0),
        (0.0, 72.0, 148.0, 224.0, 300.0, 376.0),
    ),
}

_KMH = 1.0 / 3.6


def _town03_spec() -> NetworkSpec:
  """CARNOVEL's home town: grid core + roundabout + switchback + abnormal
  junctions."""
  xs, ys = _GRIDS["Town03"]
  spec = grid_spec(xs, ys)
  nodes = dict(spec.nodes)
  edges = list(spec.edges)

  # Roundabout east of the grid, four arms.
  nodes["rb"] = (272.0, 64.0)
  nodes["rb_n"] = (272.0, 150.0)
  nodes["rb_e"] = (356.0, 64.0)
  nodes["rb_ne"] = (356.0, 228.0)
  nodes["rb_s"] = (272.0, -20.0)
  edges += [
      EdgeSpec("g2_1", "rb", via=[(225.0, 74.0)], speed=40 * _KMH,
               feature="roundabout_arm"),
      EdgeSpec("rb", "rb_n", speed=40 * _KMH, feature="roundabout_arm"),
      EdgeSpec("rb_n", "g2_2", speed=40 * _KMH, feature="roundabout_link"),
      EdgeSpec("rb", "rb_e", speed=40 * _KMH, feature="roundabout_arm"),
      EdgeSpec("rb_e", "rb_ne", speed=50 * _KMH, feature="bypass"),
      EdgeSpec("rb_ne", "g2_3", speed=50 * _KMH, feature="bypass"),
      EdgeSpec("rb", "rb_s", speed=40 * _KMH, feature="roundabout_arm"),
      EdgeSpec("rb_s", "g2_0", via=[(225.0, -18.0)], speed=40 * _KMH,
               feature="roundabout_link"),
  ]

  # Switchback serpentine north of the grid ("hills" proxy: tight
  # alternating curves) + return loop.
  nodes["hills_top"] = (0.0, 340.0)
  nodes["hills_e"] = (172.0, 340.0)
  edges += [
      EdgeSpec("g0_3", "hills_top",
               via=[(36.0, 252.0), (-36.0, 276.0), (36.0, 300.0),
                    (-36.0, 324.0)],
               speed=40 * _KMH, feature="hills", npc_allowed=False),
      EdgeSpec("hills_top", "hills_e", speed=40 * _KMH, feature="hills_top"),
      EdgeSpec("hills_e", "g2_3", speed=40 * _KMH, feature="hills_link"),
  ]

  # Abnormal turns: a 45-degree diagonal avenue + a sharp V junction.
  nodes["v_apex"] = (-64.0, 38.0)
  edges += [
      EdgeSpec("g1_1", "g2_2", speed=50 * _KMH, feature="abnormal"),
      EdgeSpec("g0_1", "v_apex", speed=30 * _KMH, feature="abnormal"),
      EdgeSpec("v_apex", "g0_0", speed=30 * _KMH, feature="abnormal"),
  ]
  return NetworkSpec(nodes=nodes, edges=edges, roundabouts={"rb": 16.0})


def _town04_spec() -> NetworkSpec:
  """The big busy town: 7x7 grid + curved diagonal arterial + east curve."""
  xs, ys = _GRIDS["Town04"]
  spec = grid_spec(xs, ys)
  nodes = dict(spec.nodes)
  edges = list(spec.edges)
  nodes["c_e"] = (620.0, 256.0)
  edges += [
      EdgeSpec("g2_2", "g4_4", via=[(285.0, 230.0)], speed=60 * _KMH,
               feature="abnormal"),
      EdgeSpec("g6_2", "c_e", via=[(600.0, 190.0)], speed=50 * _KMH,
               feature="curve"),
      EdgeSpec("c_e", "g6_4", via=[(600.0, 320.0)], speed=50 * _KMH,
               feature="curve"),
  ]
  return NetworkSpec(nodes=nodes, edges=edges)


def _town05_spec() -> NetworkSpec:
  """Mixed showcase: grid + 3-arm roundabout."""
  xs, ys = _GRIDS["Town05"]
  spec = grid_spec(xs, ys)
  nodes = dict(spec.nodes)
  edges = list(spec.edges)
  nodes["rb"] = (480.0, 188.0)
  nodes["rb_n"] = (480.0, 300.0)
  nodes["rb_s"] = (480.0, 72.0)
  edges += [
      EdgeSpec("g5_2", "rb", via=[(440.0, 160.0)], speed=40 * _KMH,
               feature="roundabout_arm"),
      EdgeSpec("rb", "rb_n", speed=40 * _KMH, feature="roundabout_arm"),
      EdgeSpec("rb_n", "g5_4", speed=40 * _KMH, feature="roundabout_link"),
      EdgeSpec("rb", "rb_s", speed=40 * _KMH, feature="roundabout_arm"),
      EdgeSpec("rb_s", "g5_1", speed=40 * _KMH, feature="roundabout_link"),
  ]
  return NetworkSpec(nodes=nodes, edges=edges, roundabouts={"rb": 14.0})


def _build(name: str) -> TownMap:
  xs, ys = _GRIDS[name]
  if name == "Town02":
    spec = grid_spec(xs, ys)
    spec.spawn_spacing = 8.0  # cover CoRL2017's index range (max 256)
    town = build_town(name, spec)
  elif name == "Town03":
    town = build_town(name, _town03_spec())
  elif name == "Town04":
    town = build_town(name, _town04_spec())
  elif name == "Town05":
    town = build_town(name, _town05_spec())
  else:
    town = build_town(name, grid_spec(xs, ys))
  pins = pins_lib.benchmark_pins(name, xs, ys)
  S = town.num_spawn_points
  pins = {idx % S: xy for idx, xy in sorted(pins.items())}
  if pins:
    town = apply_spawn_pins(town, pins)
  # No benchmark task may be unwinnable: every configured route must fit
  # the 1500-step horizon at reference cruise (maps/repair.py).
  tasks = pins_lib._load_tasks(name)
  if tasks:
    from oatomobile_torch.maps.repair import repair_benchmark_routes
    town = repair_benchmark_routes(town, tasks)
  return town


_CACHE_DIR = os.path.join(paths.BUILD_DIR, "maps")

_CACHE_VERSION = 9


def _cache_path(name: str) -> str:
  return os.path.join(_CACHE_DIR, "{}_v{}.npz".format(name, _CACHE_VERSION))


def _save_cache(town: TownMap, path: str) -> None:
  os.makedirs(os.path.dirname(path), exist_ok=True)
  arrays = {
      f.name: getattr(town, f.name)
      for f in town.__dataclass_fields__.values()
      if isinstance(getattr(town, f.name), np.ndarray)
  }
  # Write to a private file, then rename: concurrent builders (test
  # workers) never see a half-written cache.
  tmp = "{}.{}.tmp.npz".format(path[:-len(".npz")], os.getpid())
  np.savez_compressed(tmp, name=town.name, lane_width=town.lane_width,
                      raster_ppm=town.raster_ppm,
                      wall_budget=town.wall_budget,
                      road_budget=town.road_budget, **arrays)
  os.replace(tmp, path)


def _load_cache(path: str) -> TownMap:
  with np.load(path, allow_pickle=False) as data:
    return TownMap(
        name=str(data["name"]),
        lane_width=float(data["lane_width"]),
        raster_ppm=float(data["raster_ppm"]),
        wall_budget=int(data["wall_budget"]),
        road_budget=int(data["road_budget"]),
        **{
            key: data[key] for key in data.files
            if key not in ("name", "lane_width", "raster_ppm",
                           "wall_budget", "road_budget")
        })


@functools.lru_cache(maxsize=None)
def load_town(name: str) -> TownMap:
  """Loads (building + caching on first use) the named town."""
  if name not in AVAILABLE_TOWNS:
    raise ValueError("Unknown town {!r}; available: {}".format(
        name, AVAILABLE_TOWNS))
  path = _cache_path(name)
  if os.path.exists(path):
    try:
      return _load_cache(path)
    except Exception:  # Corrupt cache: rebuild.
      pass
  town = _build(name)
  try:
    _save_cache(town, path)
  except OSError:
    pass
  return town


def town_bounds(town: TownMap) -> Tuple[np.ndarray, np.ndarray]:
  """Returns (min_xy, max_xy) of the drivable area."""
  lo = town.raster_origin
  hi = lo + np.array(town.road_mask.shape, dtype=np.float32) / town.raster_ppm
  return lo, hi
