"""Benchmark spawn pinning: aligning task (origin, destination) indices
with the geometry their family names demand.

The reference's task configs (benchmarks/{carnovel,corl2017}/configs/*.json,
carried verbatim) reference CARLA spawn-point indices.  Our towns are
procedural, so which geometry an index lands on is a degree of freedom —
this module fixes it so the benchmarks keep their *semantics*:

  - Roundabouts*-v0 routes traverse Town03's ring,
  - Hills*-v0 routes climb the switchback serpentine,
  - AbnormalTurns*-v0 routes cross non-orthogonal junctions,
  - CoRL2017 Straight/Turn/FullTown tasks are straight / one-turn /
    cross-town drives of achievable length (the reference families,
    corl2017/benchmark.py:56-91).

Pins are applied once at town build time (maps/builder.apply_spawn_pins);
everything downstream (BFS routes, batched eval) follows automatically.
"""

import json
import os
from typing import Dict, List, Tuple

import numpy as np

# (suite, file, town, origin, destination) of every CARNOVEL and CoRL2017
# task config, in the sorted file order of the reference's configs
# directories: the only fields town building reads.  The full configs come
# with the benchmark classes.
_TASKS_PATH = os.path.join(os.path.dirname(__file__), "benchmark_tasks.json")


def _load_tasks(town: str) -> List[dict]:
  """All benchmark task configs referencing ``town``, sorted by file."""
  with open(_TASKS_PATH) as fp:
    rows = json.load(fp)
  return [dict(town=r["town"], origin=r["origin"],
               destination=r["destination"], _name=r["file"].split("-")[0])
          for r in rows if r["town"] == town]


# ---------------------------------------------------------------------------
# Town03 / Town04: hand-placed CARNOVEL pins (coordinates reference the
# layout constants in maps/towns.py — keep in sync).
# ---------------------------------------------------------------------------

# Pin values: (x, y) or (x, y, yaw_deg) — with a yaw, the pinned spawn must
# sit on the lane travelling in that direction (lanes are directed).
TOWN03_PINS: Dict[int, Tuple] = {
    # Roundabouts*: origins on lanes TOWARD the ring at (272, 64) R=16,
    # destinations on lanes AWAY on a different arm -> every route must
    # circulate the ring.
    257: (210.0, 76.0, 0.0),     # R0 o: W arm eastbound
    250: (330.0, 66.0, 0.0),     # R0/R3 d: E arm eastbound (outbound)
    210: (270.0, 2.0, 90.0),     # R1 o: S arm northbound
    85: (270.0, 120.0, 90.0),    # R1 d: N arm northbound (outbound)
    211: (340.0, 62.0, 180.0),   # R2 o: E arm westbound
    221: (274.0, -4.0, -90.0),   # R2 d: S arm southbound (outbound)
    123: (274.0, 100.0, -90.0),  # R3 o: N arm southbound
    88: (190.0, 76.0, 0.0),      # R4 o: W arm eastbound
    253: (270.0, 140.0, 90.0),   # R4 d: N arm northbound (outbound)
    # Hills*: the switchback serpentine (x=0..+-36, y=228..340) and its
    # top road.  "Uphill" = toward hills_top.
    73: (30.0, 250.0, 34.0),     # H0 o: uphill start
    144: (30.0, 342.0, 0.0),     # H0 d: top road eastbound
    72: (-30.0, 312.0, -18.0),   # H1 o: downhill mid
    141: (2.0, 180.0, -90.0),    # H1 d: south of serpentine
    205: (62.0, 338.0, 180.0),   # H2 o: top road westbound
    75: (-34.0, 276.0, -90.0),   # H2 d: downhill mid
    199: (80.0, 338.0, 180.0),   # H3 o: top road westbound
    142: (6.0, 238.0, -146.0),   # H3 d: downhill exit
    # AbnormalTurns*: the 45-degree diagonal (84,76)->(172,150) and the
    # sharp V at (-64, 38).
    90: (98.0, 88.0, 40.0),      # A0 o: diagonal NE-bound start
    77: (158.0, 140.0, 40.0),    # A0/A1/A3 d: diagonal NE-bound end
    254: (86.0, 40.0, 90.0),     # A1 o: northbound into the 45-deg turn
    91: (-30.0, 58.0, -149.0),   # A2 o: toward the V apex
    166: (-30.0, 18.0, -31.0),   # A2 d: out of the V apex
    61: (40.0, 78.0, 0.0),       # A3 o: eastbound into the 45-deg turn
    60: (2.0, 40.0, 90.0),       # A4 o: northbound toward g0_1
    44: (-45.0, 44.0, -149.0),   # A4 d: on the V's first leg
    160: (120.0, 110.0, 40.0),   # A5 o: diagonal NE-bound mid
    194: (174.0, 190.0, 90.0),   # A5 d: northbound after the diagonal
    # BusyTown* (Town03 part): central grid, 150-350 m routes.
    92: (84.0, 110.0),
    146: (84.0, 214.0),
    93: (120.0, 150.0),
    81: (172.0, 60.0),
    82: (40.0, 0.0),
    79: (172.0, 100.0),
    54: (0.0, 120.0),
}

TOWN04_PINS: Dict[int, Tuple] = {
    # AbnormalTurns6: across the curved diagonal (180,168)->(356,340).
    235: (205.0, 192.0, 45.0),
    253: (330.0, 320.0, 45.0),
    # BusyTown* (Town04 part): achievable central routes (150-350 m).
    168: (120.0, 168.0),
    170: (272.0, 168.0),
    365: (178.0, 90.0, 90.0),
    275: (178.0, 290.0, 90.0),
    237: (400.0, 168.0),
    250: (272.0, 256.0),
    183: (92.0, 256.0),
    166: (92.0, 400.0),
    167: (540.0, 256.0),
    364: (460.0, 168.0),
    172: (272.0, 428.0),
    182: (356.0, 490.0),
}


# ---------------------------------------------------------------------------
# Town01 / Town02: CoRL2017 pin solver over the grid layout
# ---------------------------------------------------------------------------


def _corl_pins(town: str, xs, ys) -> Dict[int, Tuple]:
  """Deterministic pins for the CoRL2017 families on a grid town.

  Straight: origin/destination on one street, 100-220 m apart, origin's
  lane pointing at the destination (a directed pin — otherwise the route
  wraps the block).
  Turn: eastbound leg into one interior junction, northbound leg out.
  FullTown: grid (L1) distance 140-300 m anywhere.
  """
  xs = np.asarray(xs, dtype=np.float64)
  ys = np.asarray(ys, dtype=np.float64)
  rng = np.random.RandomState(
      int.from_bytes(town.encode()[-4:], "little") & 0x7FFFFFFF)
  pins: Dict[int, Tuple] = {}
  margin = 16.0  # stay clear of junction keep-outs

  # Street descriptors: (axis, fixed_coord, lo, hi).
  streets = ([("v", x, ys[0] + margin, ys[-1] - margin) for x in xs] +
             [("h", y, xs[0] + margin, xs[-1] - margin) for y in ys])

  def street_point(street, t):
    axis, c, lo, hi = street
    s = lo + t * (hi - lo)
    return (c, s) if axis == "v" else (s, c)

  def directed(street, xy, toward_xy):
    """(x, y, yaw) with the lane heading along the street toward a point."""
    axis = street[0]
    if axis == "v":
      yaw = 90.0 if toward_xy[1] >= xy[1] else -90.0
    else:
      yaw = 0.0 if toward_xy[0] >= xy[0] else 180.0
    return (xy[0], xy[1], yaw)

  def place_straight(o, d):
    street = streets[rng.randint(len(streets))]
    _, _, lo, hi = street
    span = hi - lo
    L = min(rng.uniform(100.0, 220.0), span * 0.8)
    t0 = rng.uniform(0.0, 1.0 - L / span)
    po = street_point(street, t0)
    pd = street_point(street, t0 + L / span)
    pins[o] = directed(street, po, pd)
    pins[d] = directed(street, pd, (2 * pd[0] - po[0], 2 * pd[1] - po[1]))

  def place_turn(o, d):
    i = rng.randint(1, len(xs) - 1)
    j = rng.randint(0, len(ys) - 1)
    cx, cy = xs[i], ys[j]
    leg_x = rng.uniform(40.0, min(120.0, cx - xs[0] - margin))
    leg_y = rng.uniform(40.0, min(120.0, ys[-1] - cy - margin))
    pins[o] = (cx - leg_x, cy, 0.0)    # eastbound into the junction
    pins[d] = (cx, cy + leg_y, 90.0)   # northbound out of it

  def place_fulltown(o, d):
    for _ in range(60):
      sa = streets[rng.randint(len(streets))]
      sb = streets[rng.randint(len(streets))]
      pa = street_point(sa, rng.uniform(0.05, 0.95))
      pb = street_point(sb, rng.uniform(0.05, 0.95))
      l1 = abs(pa[0] - pb[0]) + abs(pa[1] - pb[1])
      if 140.0 <= l1 <= 300.0:
        pins[o] = directed(sa, pa, pb)
        pins[d] = pb
        return
    pins[o] = street_point(streets[0], 0.3)
    pins[d] = street_point(streets[0], 0.7)

  def complete_partner(fixed, family, role):
    """Partner pin when the other end is already pinned.

    ``role`` is the PARTNER's role ("origin" or "dest").  Partner pins are
    always DIRECTED: an undirected partner can land on the opposite lane
    and turn a 150 m task into a 550 m block-wrap.
    """
    fx, fy = fixed[0], fixed[1]
    fyaw = np.deg2rad(fixed[2]) if len(fixed) > 2 else None

    def along(x, y, toward_x, toward_y):
      """Directed pin at (x, y) whose lane runs along its street: a dest
      heads away from the fixed end, an origin heads toward it."""
      on_vertical = np.abs(xs - x).min() < np.abs(ys - y).min()
      if role == "dest":
        ref = (x - fx, y - fy)          # away from the fixed end
      else:
        ref = (toward_x - x, toward_y - y)  # toward the fixed end
      if on_vertical:
        return (x, y, 90.0 if ref[1] >= 0 else -90.0)
      return (x, y, 0.0 if ref[0] >= 0 else 180.0)

    if family == "straight":
      dv = np.abs(xs - fx).min()
      dh = np.abs(ys - fy).min()
      sign = rng.choice([-1, 1])
      if fyaw is not None and role == "dest":
        # Place the destination AHEAD of the fixed origin's heading.
        sign = 1 if (abs(np.cos(fyaw)) < 0.5) == (np.sin(fyaw) > 0) else -1
        if dv >= dh:  # horizontal street: sign from cos
          sign = 1 if np.cos(fyaw) > 0 else -1
        else:
          sign = 1 if np.sin(fyaw) > 0 else -1
      if dv < dh:  # fixed sits on a vertical street
        x = float(xs[np.abs(xs - fx).argmin()])
        y = float(np.clip(fy + sign * rng.uniform(100, 180),
                          ys[0] + margin, ys[-1] - margin))
        return along(x, y, fx, fy)
      y = float(ys[np.abs(ys - fy).argmin()])
      x = float(np.clip(fx + sign * rng.uniform(100, 180),
                        xs[0] + margin, xs[-1] - margin))
      return along(x, y, fx, fy)
    if family == "turn":
      # Anchor junction near (ahead of, when known) the fixed end; partner
      # on the perpendicular street through it.
      ax_, ay_ = fx, fy
      if fyaw is not None:
        ax_ += 70.0 * np.cos(fyaw)
        ay_ += 70.0 * np.sin(fyaw)
      i = int(np.clip(np.abs(xs - ax_).argmin(), 1, len(xs) - 2))
      j = int(np.clip(np.abs(ys - ay_).argmin(), 1, len(ys) - 2))
      on_vertical = np.abs(xs - fx).min() < np.abs(ys - fy).min()
      if on_vertical:  # partner goes on the horizontal street through j
        x = float(np.clip(xs[i] + rng.choice([-1, 1]) * rng.uniform(50, 110),
                          xs[0] + margin, xs[-1] - margin))
        return along(x, float(ys[j]), fx, fy)
      y = float(np.clip(ys[j] + rng.choice([-1, 1]) * rng.uniform(50, 110),
                        ys[0] + margin, ys[-1] - margin))
      return along(float(xs[i]), y, fx, fy)
    for _ in range(40):
      street = streets[rng.randint(len(streets))]
      p = street_point(street, rng.uniform(0.1, 0.9))
      l1 = abs(p[0] - fx) + abs(p[1] - fy)
      if 140.0 <= l1 <= 300.0:
        return along(p[0], p[1], fx, fy)
    p = street_point(streets[-1], 0.5)
    return along(p[0], p[1], fx, fy)

  for task in _load_tasks(town):
    name = task["_name"]
    if "Straight" in name:
      family = "straight"
    elif "Turn" in name:
      family = "turn"
    else:
      family = "fulltown"
    o, d = int(task["origin"]), int(task["destination"])
    if o in pins and d in pins:
      continue
    if o in pins:
      pins[d] = complete_partner(pins[o], family, "dest")
      continue
    if d in pins:
      pins[o] = complete_partner(pins[d], family, "origin")
      continue
    if family == "straight":
      place_straight(o, d)
    elif family == "turn":
      place_turn(o, d)
    else:
      place_fulltown(o, d)
  return pins


def benchmark_pins(town: str, xs=None, ys=None) -> Dict[int,
                                                        Tuple[float, float]]:
  """Returns the spawn pins for ``town`` (empty dict when none apply)."""
  if town == "Town03":
    return dict(TOWN03_PINS)
  if town == "Town04":
    return dict(TOWN04_PINS)
  if town in ("Town01", "Town02") and xs is not None:
    return _corl_pins(town, xs, ys)
  return {}
