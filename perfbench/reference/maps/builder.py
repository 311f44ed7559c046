"""Procedural town builder: road-network specs -> TownMap arrays.

Replaces CARLA's OpenDrive towns with deterministic, procedurally generated
road networks that expose the same *structural* interface the reference
consumes: a directed lane-waypoint graph with ~2 m spacing and junction
connectors (``waypoint.next()`` semantics of the CARLA map API), spawn
points, traffic lights, and road/lane rasters (semantics of
upstream oatomobile/utils/graphics.py:430-711).

Unlike round 1's grid-only generator, towns are described as a **network
spec** — named junction nodes plus edges whose centerlines may be straight
or curved (Catmull-Rom through via points) — and nodes may be
**roundabouts** (one-way circulating ring with merge/diverge connectors).
This is what gives CARNOVEL's task families their geometry: Roundabouts*
tasks traverse a real ring, Hills* a switchback serpentine, AbnormalTurns*
non-orthogonal junctions.

Conventions (CARLA-compatible observables):
  - x forward / y right, yaw in radians here (degrees only at sensor edge),
  - right-hand traffic: the lane for heading ``u`` is offset ``+half_lane``
    along ``right(u) = (-u_y, u_x)``,
  - roundabouts circulate with the island on the driver's LEFT.

TPU hot-path geometry: all static geometry is ALSO emitted as **oriented
rectangles** ``(cx, cy, hx, hy, cos t, sin t)`` — wall bands and road
corridors — so the BEV splat and static-collision tests stay gather-free
elementwise math (per-pixel raster gathers are pathological on TPU).
"""

import dataclasses
import hashlib
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from perfbench.reference.maps.assets import MAX_NEXT, TownMap

# Geometry constants.
LANE_WIDTH = 3.5          # meters, CARLA town default
LANE_OFFSET = LANE_WIDTH / 2.0
JUNCTION_HALF = 8.0       # junction keep-out radius, meters
WAYPOINT_SPACING = 2.0    # meters between consecutive lane waypoints
SPAWN_SPACING = 12.0      # meters between spawn points along lanes
SPEED_LIMIT_MPS = 30.0 / 3.6  # 30 km/h, CARLA town default
TL_GREEN = 10.0           # seconds
TL_YELLOW = 3.0
RASTER_PPM = 2.0          # raster pixels per meter
SIDEWALK = 2.0            # meters of clear margin beyond road edge
WALL_THICK = 1.5          # street-facing wall band thickness
HALF_ROAD = LANE_WIDTH    # two lanes -> road half-width
RING_HALF = LANE_WIDTH * 0.75  # roundabout circulating-lane half-width
RING_APRON = 6.0          # keep-out beyond the ring radius for lane trims
DENSE = 0.5               # dense centerline sampling, meters


def _right(u: np.ndarray) -> np.ndarray:
  """Right-hand vector(s) of heading u in the x-forward/y-right frame."""
  u = np.asarray(u)
  return np.stack([-u[..., 1], u[..., 0]], axis=-1)


def _det_hash(*vals) -> float:
  """Deterministic [0,1) hash."""
  h = hashlib.md5("_".join(map(str, vals)).encode()).digest()
  return int.from_bytes(h[:4], "little") / 2**32


# ---------------------------------------------------------------------------
# Network spec
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class EdgeSpec:
  """A two-way, two-lane road between nodes ``a`` and ``b``.

  ``via``: optional interior control points; the centerline is a
  Catmull-Rom spline through [a, *via, b] (straight when absent).
  ``speed``: per-road speed limit (m/s) — towns are heterogeneous.
  ``feature``: free-form tag ("roundabout_arm", "hills", "abnormal", ...)
  used by spawn pinning to align benchmark tasks with geometry.
  """
  a: str
  b: str
  via: Optional[Sequence[Tuple[float, float]]] = None
  speed: float = SPEED_LIMIT_MPS
  feature: str = ""
  # NPC traffic permitted on this road (False for e.g. narrow hairpin
  # passes where two-way background traffic is unrealistic).
  npc_allowed: bool = True


@dataclasses.dataclass
class NetworkSpec:
  nodes: Mapping[str, Tuple[float, float]]
  edges: Sequence[EdgeSpec]
  # node name -> ring radius; these nodes become roundabouts.
  roundabouts: Mapping[str, float] = dataclasses.field(default_factory=dict)
  # Optional explicit traffic-light node set; default: deterministic ~half
  # of all 4-way junctions.
  lights_at: Optional[Sequence[str]] = None
  # Spawn-point spacing along lanes (small towns densify to cover their
  # benchmark index range).
  spawn_spacing: float = SPAWN_SPACING


# ---------------------------------------------------------------------------
# Curve sampling
# ---------------------------------------------------------------------------


def _resample(dense: np.ndarray, spacing: float,
              closed: bool = False) -> Tuple[np.ndarray, np.ndarray]:
  """Arc-length resampling of a dense polyline; returns (points, yaws)."""
  seg = np.linalg.norm(np.diff(dense, axis=0), axis=1)
  arclen = np.concatenate([[0.0], np.cumsum(seg)])
  total = arclen[-1]
  n = max(int(round(total / spacing)), 1) + (0 if closed else 1)
  targets = (np.arange(n) * total / n if closed
             else np.linspace(0.0, total, n))
  pts = np.stack([np.interp(targets, arclen, dense[:, d]) for d in (0, 1)],
                 axis=-1)
  # Tangents by central differences on the resampled points.
  if closed:
    fwd = np.roll(pts, -1, axis=0) - np.roll(pts, 1, axis=0)
  else:
    fwd = np.gradient(pts, axis=0)
  yaw = np.arctan2(fwd[:, 1], fwd[:, 0])
  return pts, yaw


def _catmull_rom(points: np.ndarray, samples_per_seg: int = 32) -> np.ndarray:
  """Dense Catmull-Rom spline through ``points`` [N>=2, 2]."""
  P = np.asarray(points, dtype=np.float64)
  if len(P) == 2:
    t = np.linspace(0, 1, samples_per_seg)[:, None]
    return P[0] * (1 - t) + P[1] * t
  # Endpoint phantom points (natural extension).
  ext = np.concatenate([[2 * P[0] - P[1]], P, [2 * P[-1] - P[-2]]], axis=0)
  out = []
  for i in range(len(P) - 1):
    p0, p1, p2, p3 = ext[i], ext[i + 1], ext[i + 2], ext[i + 3]
    t = np.linspace(0, 1, samples_per_seg, endpoint=False)[:, None]
    t2, t3 = t * t, t * t * t
    out.append(0.5 * ((2 * p1) + (-p0 + p2) * t +
                      (2 * p0 - 5 * p1 + 4 * p2 - p3) * t2 +
                      (-p0 + 3 * p1 - 3 * p2 + p3) * t3))
  out.append(P[-1:])
  return np.concatenate(out, axis=0)


def _sample_bezier(p0: np.ndarray, c: np.ndarray, p1: np.ndarray,
                   spacing: float) -> Tuple[np.ndarray, np.ndarray]:
  """Quadratic bezier sampled ~uniformly in arc length, with tangents."""
  t = np.linspace(0.0, 1.0, 64)[:, None]
  dense = ((1 - t)**2 * p0[None] + 2 * (1 - t) * t * c[None] + t**2 * p1[None])
  seglen = np.linalg.norm(np.diff(dense, axis=0), axis=1)
  arclen = np.concatenate([[0.0], np.cumsum(seglen)])
  total = arclen[-1]
  n = max(int(round(total / spacing)), 2) + 1
  targets = np.linspace(0.0, total, n)
  ts = np.interp(targets, arclen, t[:, 0])[:, None]
  pts = ((1 - ts)**2 * p0[None] + 2 * (1 - ts) * ts * c[None] +
         ts**2 * p1[None])
  tangents = (2 * (1 - ts) * (c[None] - p0[None]) + 2 * ts *
              (p1[None] - c[None]))
  yaw = np.arctan2(tangents[:, 1], tangents[:, 0])
  return pts, yaw


def _offset_polyline(pts: np.ndarray, yaw: np.ndarray,
                     offset: float) -> np.ndarray:
  """Offsets a polyline laterally (+ = right of travel direction)."""
  u = np.stack([np.cos(yaw), np.sin(yaw)], axis=-1)
  return pts + offset * _right(u)


def _trim_polyline(pts: np.ndarray, a_xy, a_keep: float, b_xy,
                   b_keep: float) -> np.ndarray:
  """Drops leading points within ``a_keep`` of a and trailing within
  ``b_keep`` of b."""
  da = np.linalg.norm(pts - np.asarray(a_xy)[None], axis=1)
  db = np.linalg.norm(pts - np.asarray(b_xy)[None], axis=1)
  keep = (da >= a_keep) & (db >= b_keep)
  idx = np.nonzero(keep)[0]
  if len(idx) < 4:
    raise ValueError("Edge too short after junction trims")
  return pts[idx[0]:idx[-1] + 1]


def _polyline_to_rects(pts: np.ndarray, half_width: float,
                       tol: float = 0.35, max_len: float = 2000.0,
                       overlap: float = 0.4) -> List[np.ndarray]:
  """Greedy chord decomposition of a polyline into oriented rects
  (cx, cy, hx, hy, cos, sin) covering a band of ``half_width``.

  Each chord extends while every interior point stays within ``tol`` of
  the chord line; ``hy`` absorbs the residual deviation so coverage is
  conservative (a superset of the true band within tol).
  """
  rects: List[np.ndarray] = []
  n = len(pts)
  i = 0
  while i < n - 1:
    j = min(i + 2, n - 1)
    best_dev = 0.0
    while j < n - 1:
      chord = pts[j + 1] - pts[i]
      clen = np.linalg.norm(chord)
      if clen > max_len:
        break
      u = chord / max(clen, 1e-9)
      rel = pts[i:j + 2] - pts[i]
      dev = np.abs(rel[:, 0] * u[1] - rel[:, 1] * u[0])
      along = rel @ u
      if dev.max() > tol or along.min() < -0.1 or along.max() > clen + 0.1:
        break
      best_dev = dev.max()
      j += 1
    chord = pts[j] - pts[i]
    clen = np.linalg.norm(chord)
    if clen < 1e-6:
      i = j
      continue
    u = chord / clen
    center = (pts[i] + pts[j]) / 2.0
    rects.append(np.array([
        center[0], center[1], clen / 2.0 + overlap, half_width + best_dev,
        u[0], u[1]
    ], dtype=np.float32))
    i = j
  return rects


# ---------------------------------------------------------------------------
# Graph accumulator
# ---------------------------------------------------------------------------


class _GraphAccumulator:
  """Collects waypoints and edges while building lanes and connectors."""

  def __init__(self):
    self.xy: List[np.ndarray] = []
    self.yaw: List[float] = []
    self.road_id: List[int] = []
    self.lane_id: List[int] = []
    self.is_junction: List[bool] = []
    self.speed: List[float] = []
    self.npc_ok: List[bool] = []
    self.edges: List[Tuple[int, int]] = []

  def add_polyline(self, points: np.ndarray, yaws: np.ndarray, road_id: int,
                   lane_id: int, junction: bool, speed: float,
                   closed: bool = False,
                   npc_ok: bool = True) -> Tuple[int, int]:
    """Adds a chained sequence of waypoints; returns (first_id, last_id)."""
    base = len(self.xy)
    n = len(points)
    for k in range(n):
      self.xy.append(np.asarray(points[k], dtype=np.float64))
      self.yaw.append(float(yaws[k]))
      self.road_id.append(road_id)
      self.lane_id.append(lane_id)
      self.is_junction.append(junction)
      self.speed.append(speed)
      self.npc_ok.append(npc_ok)
      if k > 0:
        self.edges.append((base + k - 1, base + k))
    if closed and n > 1:
      self.edges.append((base + n - 1, base))
    return base, base + n - 1

  def connect(self, src: int, dst: int) -> None:
    self.edges.append((src, dst))


# ---------------------------------------------------------------------------
# Raster distance fields
# ---------------------------------------------------------------------------


def _dist_to_polyline_field(gx: np.ndarray, gy: np.ndarray,
                            pts: np.ndarray,
                            pad: float) -> Tuple[slice, slice, np.ndarray]:
  """Distance from raster cells (within the polyline's padded bbox) to the
  polyline's dense points (cKDTree; points are ~0.25 m apart so the
  point-vs-segment error is < 0.13 m).  Returns (rows, cols, dist)."""
  from scipy.spatial import cKDTree
  lo = pts.min(axis=0) - pad
  hi = pts.max(axis=0) + pad
  r0 = int(np.searchsorted(gx, lo[0]))
  r1 = int(np.searchsorted(gx, hi[0])) + 1
  c0 = int(np.searchsorted(gy, lo[1]))
  c1 = int(np.searchsorted(gy, hi[1])) + 1
  rows = gx[r0:r1]
  cols = gy[c0:c1]
  cells = np.stack(np.meshgrid(rows, cols, indexing="ij"), axis=-1)
  d, _ = cKDTree(pts).query(cells.reshape(-1, 2), workers=1)
  return (slice(r0, r1), slice(c0, c1),
          d.astype(np.float32).reshape(len(rows), len(cols)))


# ---------------------------------------------------------------------------
# The builder
# ---------------------------------------------------------------------------


def build_town(name: str, spec: NetworkSpec) -> TownMap:
  """Builds a TownMap from a road-network spec."""
  nodes = {k: np.asarray(v, dtype=np.float64) for k, v in spec.nodes.items()}
  ring_r = dict(spec.roundabouts)
  acc = _GraphAccumulator()

  def keepout(node: str) -> float:
    if node in ring_r:
      return ring_r[node] + RING_APRON
    return JUNCTION_HALF

  # ---- 1. Edge centerlines (dense) + directed lanes --------------------
  # approaches[(node, k)] / departures[(node, k)]: lane ends arriving at /
  # leaving node, with their endpoint positions and tangents.
  approaches: Dict[str, List[dict]] = {n: [] for n in nodes}
  departures: Dict[str, List[dict]] = {n: [] for n in nodes}
  # Per-edge artefacts for rasters/rects/spawns.
  edge_center_full: List[np.ndarray] = []   # untrimmed dense centerline
  edge_center_trim: List[np.ndarray] = []   # trimmed dense centerline
  lane_spans: List[Tuple[int, int, int]] = []  # (first, last, edge_idx)

  for ei, e in enumerate(spec.edges):
    a_xy, b_xy = nodes[e.a], nodes[e.b]
    ctrl = [a_xy] + [np.asarray(v, np.float64) for v in (e.via or [])] + [b_xy]
    dense = _catmull_rom(np.asarray(ctrl), samples_per_seg=64)
    # Densify to ~DENSE spacing.
    dense, _ = _resample(dense, DENSE)
    edge_center_full.append(dense)
    trimmed = _trim_polyline(dense, a_xy, keepout(e.a), b_xy, keepout(e.b))
    edge_center_trim.append(trimmed)

    for direction in (+1, -1):
      cl = trimmed if direction > 0 else trimmed[::-1]
      cpts, cyaw = _resample(cl, WAYPOINT_SPACING)
      lane = _offset_polyline(cpts, cyaw, LANE_OFFSET)
      first, last = acc.add_polyline(lane, cyaw, ei, direction, False,
                                     e.speed, npc_ok=e.npc_allowed)
      lane_spans.append((first, last, ei))
      src_node = e.a if direction > 0 else e.b
      dst_node = e.b if direction > 0 else e.a
      departures[src_node].append(dict(wp=first, xy=lane[0], yaw=cyaw[0],
                                       edge=ei))
      approaches[dst_node].append(dict(wp=last, xy=lane[-1], yaw=cyaw[-1],
                                       edge=ei, first=first))

  # ---- 2. Roundabout rings ---------------------------------------------
  ring_road_base = len(spec.edges)
  ring_info: Dict[str, dict] = {}
  for ri, (node, R) in enumerate(sorted(ring_r.items())):
    C = nodes[node]
    n_ring = max(int(round(2 * np.pi * R / WAYPOINT_SPACING)), 8)
    # Circulate with the island on the driver's left: phi DECREASING.
    phi = -2 * np.pi * np.arange(n_ring) / n_ring
    pts = C[None, :] + R * np.stack([np.cos(phi), np.sin(phi)], axis=-1)
    fwd = np.roll(pts, -1, axis=0) - np.roll(pts, 1, axis=0)
    yaw = np.arctan2(fwd[:, 1], fwd[:, 0])
    first, last = acc.add_polyline(pts, yaw, ring_road_base + ri, 1, False,
                                   40.0 / 3.6, closed=True)
    ring_info[node] = dict(first=first, n=n_ring, xy=pts, yaw=yaw, R=R, C=C)

  # ---- 3. Junction connectors -------------------------------------------
  conn_road_base = ring_road_base + len(ring_r)
  tl_xy: List[np.ndarray] = []
  tl_group: List[int] = []
  tl_offset: List[float] = []
  tl_approach: List[Tuple[int, int, int]] = []  # (last_wp, first_wp, tl_id)

  def add_connector(p_in, yaw_in, src_wp, p_out, yaw_out, dst_wp, road_id,
                    speed):
    u_in = np.array([np.cos(yaw_in), np.sin(yaw_in)])
    u_out = np.array([np.cos(yaw_out), np.sin(yaw_out)])
    # Control point: intersection of entry/exit tangent lines.
    denom = u_in[0] * u_out[1] - u_in[1] * u_out[0]
    d = np.asarray(p_out, np.float64) - np.asarray(p_in, np.float64)
    dist = np.linalg.norm(d)
    if abs(denom) > 1e-3:
      s = (d[0] * u_out[1] - d[1] * u_out[0]) / denom
      s = np.clip(s, 0.15 * dist, 1.2 * dist)
      ctrl = p_in + s * u_in
    else:
      ctrl = (np.asarray(p_in) + np.asarray(p_out)) / 2.0
    pts, yaw = _sample_bezier(np.asarray(p_in, np.float64), ctrl,
                              np.asarray(p_out, np.float64),
                              WAYPOINT_SPACING)
    interior_pts, interior_yaw = pts[1:-1], yaw[1:-1]
    if len(interior_pts) == 0:
      acc.connect(src_wp, dst_wp)
    else:
      first, last = acc.add_polyline(interior_pts, interior_yaw, road_id, 0,
                                     True, speed)
      acc.connect(src_wp, first)
      acc.connect(last, dst_wp)

  conn_count = 0
  for node in sorted(nodes):
    if node in ring_r:
      # Roundabout: merge each approach into the ring, diverge to each
      # departure.  No cross-connectors, no lights.
      info = ring_info[node]
      rxy, ryaw, rfirst, n_ring = (info["xy"], info["yaw"], info["first"],
                                   info["n"])
      for ap in approaches[node]:
        u_in = np.array([np.cos(ap["yaw"]), np.sin(ap["yaw"])])
        to_ring = rxy - np.asarray(ap["xy"])[None]
        dist = np.linalg.norm(to_ring, axis=1)
        ahead = (to_ring @ u_in) > 0.3 * dist  # merge point lies ahead
        tangent_ok = (np.cos(ryaw - ap["yaw"]) > -0.2)
        score = np.where(ahead & tangent_ok, dist, np.inf)
        k = int(np.argmin(score))
        add_connector(ap["xy"], ap["yaw"], ap["wp"], rxy[k], ryaw[k],
                      rfirst + k, conn_road_base + conn_count, 30.0 / 3.6)
        conn_count += 1
      for dp in departures[node]:
        u_out = np.array([np.cos(dp["yaw"]), np.sin(dp["yaw"])])
        from_ring = np.asarray(dp["xy"])[None] - rxy
        dist = np.linalg.norm(from_ring, axis=1)
        ahead = (from_ring @ u_out) > 0.3 * dist
        tangent_ok = (np.cos(ryaw - dp["yaw"]) > -0.2)
        score = np.where(ahead & tangent_ok, dist, np.inf)
        k = int(np.argmin(score))
        add_connector(rxy[k], ryaw[k], rfirst + k, dp["xy"], dp["yaw"],
                      dp["wp"], conn_road_base + conn_count, 30.0 / 3.6)
        conn_count += 1
      continue

    ins = approaches[node]
    outs = departures[node]
    for ap in ins:
      made = 0
      # Sort outgoing by |turn| so the capacity cap keeps the gentlest.
      def turn_of(dp):
        return abs(np.arctan2(np.sin(dp["yaw"] - ap["yaw"]),
                              np.cos(dp["yaw"] - ap["yaw"])))
      for dp in sorted(outs, key=turn_of):
        if dp["edge"] == ap["edge"]:
          continue  # no U-turn back onto the same road
        if turn_of(dp) > np.deg2rad(150) and made > 0:
          continue  # skip near-U-turns unless it's the only option
        if made >= MAX_NEXT - 1:
          break
        add_connector(ap["xy"], ap["yaw"], ap["wp"], dp["xy"], dp["yaw"],
                      dp["wp"], conn_road_base + conn_count, 30.0 / 3.6)
        conn_count += 1
        made += 1

    # Traffic lights at ~half of all 4-way junctions (deterministic), or
    # at the explicit spec list.
    is_4way = len(ins) >= 4 and len(outs) >= 4
    lit = (node in set(spec.lights_at)
           if spec.lights_at is not None
           else (is_4way and _det_hash(name, node) < 0.55))
    if lit and ins:
      offset = float(_det_hash(name, node, "o") * 2 * (TL_GREEN + TL_YELLOW))
      axis = ins[0]["yaw"]
      for ap in ins:
        # DIAGONAL approaches (30-60 deg off the junction's principal
        # axis, e.g. the 5th arm of a 5-way) get NO light: a two-phase
        # controller would hand them a protected green that conflicts
        # with one axis no matter the group (measured: the Town03
        # 5-way's -140 deg arm in group 0 tangled with the E-W green
        # every cycle and crawled BusyTown7/9 to 90% timeouts).
        # Unsignalised, its traffic yields on entry via the standard
        # crossing-mover rules and enters on phase-switch gaps, with
        # patience assertion preventing starvation.
        rel = (ap["yaw"] - axis) % (np.pi / 2)
        if np.deg2rad(30) < rel < np.deg2rad(60):
          continue
        u_in = np.array([np.cos(ap["yaw"]), np.sin(ap["yaw"])])
        pole = (np.asarray(ap["xy"]) +
                (LANE_OFFSET + LANE_WIDTH) * _right(u_in))
        tl_id = len(tl_xy)
        tl_xy.append(pole)
        # Phase group by heading axis: approaches within 45 deg of the
        # first approach's axis (mod pi) share a group.
        rel = (ap["yaw"] - axis) % np.pi
        tl_group.append(0 if min(rel, np.pi - rel) < np.pi / 4 else 1)
        tl_offset.append(offset)
        tl_approach.append((ap["wp"], ap["first"], tl_id))

  # ---- 4. Finalise graph arrays ---------------------------------------
  W = len(acc.xy)
  wp_xy = np.asarray(acc.xy, dtype=np.float32)
  wp_yaw = np.asarray(acc.yaw, dtype=np.float32)
  wp_road_id = np.asarray(acc.road_id, dtype=np.int32)
  wp_lane_id = np.asarray(acc.lane_id, dtype=np.int32)
  wp_is_junction = np.asarray(acc.is_junction)
  wp_speed_limit = np.asarray(acc.speed, dtype=np.float32)
  wp_npc_ok = np.asarray(acc.npc_ok)

  wp_next = np.full((W, MAX_NEXT), -1, dtype=np.int32)
  wp_num_next = np.zeros(W, dtype=np.int32)
  for src, dst in acc.edges:
    k = wp_num_next[src]
    if k < MAX_NEXT:
      wp_next[src, k] = dst
      wp_num_next[src] = k + 1
  # Terminal waypoints self-loop so in-graph gathers never read -1.
  terminal = wp_num_next == 0
  wp_next[terminal, 0] = np.nonzero(terminal)[0]
  wp_num_next[terminal] = 1
  for k in range(1, MAX_NEXT):
    unset = wp_next[:, k] < 0
    wp_next[unset, k] = wp_next[unset, 0]

  # NPC-restriction upstream closure: a waypoint ALL of whose real
  # successors are restricted is itself restricted (to fixpoint).  The
  # NPC branch re-pick (sim/traffic.py) can only divert where an
  # allowed branch EXISTS; without this closure the committed approach
  # chain of a restricted pass stays "allowed", its entry waypoint has
  # no legal branch, and the never-strand fallback funnels NPCs onto
  # the pass anyway (measured: 100-vehicle Hills episodes put NPCs on
  # the Town03 serpentine, meeting the hero head-on at hairpin apexes
  # where the opposing lanes are < 3 m apart — scripts/diag_hills.py).
  for _ in range(W):
    succ_ok = np.zeros(W, bool)
    for k in range(MAX_NEXT):
      valid = k < wp_num_next
      succ_ok |= valid & wp_npc_ok[wp_next[:, k]] & (
          wp_next[:, k] != np.arange(W))
    # Terminal self-loops keep their own flag.
    self_loop = wp_next[:, 0] == np.arange(W)
    new_ok = wp_npc_ok & (succ_ok | self_loop)
    if (new_ok == wp_npc_ok).all():
      break
    wp_npc_ok = new_ok

  # Traffic light governance: the last ~5 m of each governed approach.
  wp_tl = np.full(W, -1, dtype=np.int32)
  governed_span = int(round(5.0 / WAYPOINT_SPACING)) + 1
  for last_wp, first_wp, tl_id in tl_approach:
    start = max(first_wp, last_wp - governed_span + 1)
    wp_tl[start:last_wp + 1] = tl_id

  # ---- 5. Spawn points --------------------------------------------------
  spawn: List[int] = []
  spawn_edge: List[int] = []
  stride = max(int(round(spec.spawn_spacing / WAYPOINT_SPACING)), 1)
  margin = 3
  for first, last, ei in lane_spans:
    ids = list(range(first + margin, last - margin + 1, stride))
    spawn.extend(ids)
    spawn_edge.extend([ei] * len(ids))
  spawn_arr = np.asarray(spawn, dtype=np.int32)
  spawn_edge_arr = np.asarray(spawn_edge, dtype=np.int32)
  rng = np.random.RandomState(
      int.from_bytes(hashlib.md5(name.encode()).digest()[:4], "little"))
  perm = rng.permutation(len(spawn_arr))
  spawn_arr = spawn_arr[perm]
  spawn_edge_arr = spawn_edge_arr[perm]

  # ---- 6. Rasters --------------------------------------------------------
  all_pts = np.concatenate([wp_xy] + [i["xy"] for i in ring_info.values()]
                           if ring_info else [wp_xy], axis=0)
  pad = 24.0
  x_min, x_max = all_pts[:, 0].min() - pad, all_pts[:, 0].max() + pad
  y_min, y_max = all_pts[:, 1].min() - pad, all_pts[:, 1].max() + pad
  H = int(round((x_max - x_min) * RASTER_PPM)) + 1
  Wd = int(round((y_max - y_min) * RASTER_PPM)) + 1
  gx = x_min + np.arange(H) / RASTER_PPM
  gy = y_min + np.arange(Wd) / RASTER_PPM

  near_road = np.full((H, Wd), np.inf, dtype=np.float32)
  lane_mask = np.zeros((H, Wd), dtype=bool)
  field_pad = HALF_ROAD + SIDEWALK + WALL_THICK + 3.0

  # Road sources: untrimmed edge centerlines (corridors meet at nodes),
  # refined to 0.25 m so the KDTree point-distance error stays < 0.13 m.
  for ei, dense in enumerate(edge_center_full):
    fine, _ = _resample(dense, 0.25)
    rs, cs, d = _dist_to_polyline_field(gx, gy, fine, field_pad)
    near_road[rs, cs] = np.minimum(near_road[rs, cs], d - HALF_ROAD)
    lane_mask[rs, cs] |= (d <= 0.15) | (np.abs(d - HALF_ROAD) <= 0.25)
  # Ring annuli.
  for info in ring_info.values():
    n_fine = max(int(round(2 * np.pi * info["R"] / 0.25)), 64)
    phi = np.linspace(0, 2 * np.pi, n_fine)
    fine = info["C"][None] + info["R"] * np.stack(
        [np.cos(phi), np.sin(phi)], axis=-1)
    rs, cs, d = _dist_to_polyline_field(gx, gy, fine, field_pad)
    near_road[rs, cs] = np.minimum(near_road[rs, cs], d - RING_HALF)
    lane_mask[rs, cs] |= np.abs(d - RING_HALF) <= 0.25
  # Junction-connector corridors (Y-junction wedges, ring aprons).
  conn_pts = wp_xy[wp_is_junction]
  if len(conn_pts) > 0:
    rs, cs, d = _dist_to_polyline_field(gx, gy, conn_pts, field_pad)
    near_road[rs, cs] = np.minimum(near_road[rs, cs], d - HALF_ROAD)

  road = near_road <= 0.0
  # No lane markings inside junction keep-outs.
  for node, xy in nodes.items():
    if node in ring_r:
      continue
    rs, cs, d = _dist_to_polyline_field(gx, gy, xy[None, :], JUNCTION_HALF + 2)
    lane_mask[rs, cs] &= d > JUNCTION_HALF
  lane_mask &= road

  obstacle = near_road > SIDEWALK
  wall_mask = obstacle & (near_road <= SIDEWALK + WALL_THICK)

  # ---- 7. Oriented-rect geometry (TPU hot path) -------------------------
  clear = HALF_ROAD + SIDEWALK

  def _near_road_at(pts_q: np.ndarray) -> np.ndarray:
    ix = np.clip(np.round((pts_q[:, 0] - x_min) * RASTER_PPM).astype(int), 0,
                 H - 1)
    iy = np.clip(np.round((pts_q[:, 1] - y_min) * RASTER_PPM).astype(int), 0,
                 Wd - 1)
    return near_road[ix, iy]

  def _wall_runs(wall_pts: np.ndarray) -> List[np.ndarray]:
    """Splits a candidate wall polyline into runs that really face a
    street: samples where ANOTHER road comes closer (junction openings,
    merging corridors) are dropped."""
    ok = _near_road_at(wall_pts) >= SIDEWALK - 0.35
    runs = []
    start = None
    for i, flag in enumerate(ok):
      if flag and start is None:
        start = i
      elif not flag and start is not None:
        if i - start >= 6:  # >= 3 m
          runs.append(wall_pts[start:i])
        start = None
    if start is not None and len(wall_pts) - start >= 6:
      runs.append(wall_pts[start:])
    return runs

  wall_rects: List[np.ndarray] = []
  road_rects: List[np.ndarray] = []
  for ei, dense in enumerate(edge_center_full):
    road_rects.extend(_polyline_to_rects(dense, HALF_ROAD))
    trimmed = edge_center_trim[ei]
    tpts, tyaw = _resample(trimmed, DENSE)
    for side in (+1, -1):
      wall_line = _offset_polyline(tpts, tyaw,
                                   side * (clear + WALL_THICK / 2))
      for run in _wall_runs(wall_line):
        wall_rects.extend(_polyline_to_rects(run, WALL_THICK / 2))
  # Ring chords use a coarser tolerance (0.35 m would decompose each
  # circle into ~15 chords and blow the per-scene rect budget; walls are
  # range decoration, and the +-0.8 m road slack is absorbed by `hy`
  # inflation, keeping coverage conservative).
  for info in ring_info.values():
    road_rects.extend(_polyline_to_rects(
        np.concatenate([info["xy"], info["xy"][:1]], axis=0), RING_HALF,
        tol=0.8))
    # Outer ring wall (broken at arm openings) + island wall.
    R, C = info["R"], info["C"]
    n_out = max(int(round(2 * np.pi * (R + RING_HALF + SIDEWALK) / DENSE)), 16)
    phi = np.linspace(0, 2 * np.pi, n_out)
    outer = C[None] + (R + RING_HALF + SIDEWALK + WALL_THICK / 2) * \
        np.stack([np.cos(phi), np.sin(phi)], axis=-1)
    for run in _wall_runs(outer):
      wall_rects.extend(_polyline_to_rects(run, WALL_THICK / 2, tol=0.9))
    r_island = R - RING_HALF - SIDEWALK - WALL_THICK / 2
    if r_island > 2.0:
      n_in = max(int(round(2 * np.pi * r_island / DENSE)), 16)
      phi = np.linspace(0, 2 * np.pi, n_in)
      island = C[None] + r_island * np.stack([np.cos(phi), np.sin(phi)],
                                             axis=-1)
      wall_rects.extend(_polyline_to_rects(island, WALL_THICK / 2, tol=0.9))

  # Nearest-waypoint raster (localisation gather).
  from scipy.spatial import cKDTree
  tree = cKDTree(wp_xy)
  GX, GY = np.meshgrid(gx, gy, indexing="ij")
  cells = np.stack([GX.ravel(), GY.ravel()], axis=-1)
  _, idx = tree.query(cells, workers=1)
  nearest = idx.astype(np.int32).reshape(H, Wd)

  # Measured BEV rect budgets (static per-town selection counts): the max
  # number of wall rects within 52 m / road rects within 75 m of any lane
  # waypoint, +2 headroom.  Grid towns need ~14/10; roundabout towns more.
  def _budget(rect_list, radius):
    rects = np.asarray(rect_list, dtype=np.float64)
    pts = wp_xy[::3].astype(np.float64)
    dx = pts[:, None, 0] - rects[None, :, 0]
    dy = pts[:, None, 1] - rects[None, :, 1]
    u = rects[None, :, 4] * dx + rects[None, :, 5] * dy
    v = -rects[None, :, 5] * dx + rects[None, :, 4] * dy
    du = np.maximum(np.abs(u) - rects[None, :, 2], 0.0)
    dv = np.maximum(np.abs(v) - rects[None, :, 3], 0.0)
    d = np.sqrt(du * du + dv * dv)
    return int((d < radius).sum(axis=1).max()) + 2

  wall_budget = _budget(wall_rects, 52.0)
  road_budget = _budget(road_rects, 75.0)

  return TownMap(
      name=name,
      lane_width=LANE_WIDTH,
      wp_xy=wp_xy,
      wp_yaw=wp_yaw,
      wp_next=wp_next,
      wp_num_next=wp_num_next,
      wp_road_id=wp_road_id,
      wp_lane_id=wp_lane_id,
      wp_is_junction=wp_is_junction,
      wp_speed_limit=wp_speed_limit,
      wp_tl=wp_tl,
      spawn_wp=spawn_arr,
      spawn_edge=spawn_edge_arr,
      tl_xy=(np.asarray(tl_xy, dtype=np.float32)
             if tl_xy else np.zeros((0, 2), dtype=np.float32)),
      tl_group=np.asarray(tl_group, dtype=np.int32),
      tl_offset=np.asarray(tl_offset, dtype=np.float32),
      raster_origin=np.array([x_min, y_min], dtype=np.float32),
      raster_ppm=RASTER_PPM,
      road_mask=road,
      lane_mask=lane_mask,
      obstacle_mask=obstacle,
      wall_mask=wall_mask,
      nearest_wp=nearest,
      wall_rects=np.asarray(wall_rects, dtype=np.float32),
      road_rects=np.asarray(road_rects, dtype=np.float32),
      wall_budget=wall_budget,
      road_budget=road_budget,
      wp_npc_ok=wp_npc_ok,
  )


# ---------------------------------------------------------------------------
# Grid towns as a spec (Town01/Town02 and the cores of the big towns)
# ---------------------------------------------------------------------------


def grid_spec(xs: Sequence[float], ys: Sequence[float],
              speed: float = SPEED_LIMIT_MPS,
              feature: str = "grid") -> NetworkSpec:
  """A rectangular grid of two-lane streets as a NetworkSpec."""
  nodes = {}
  for i, x in enumerate(xs):
    for j, y in enumerate(ys):
      nodes["g{}_{}".format(i, j)] = (float(x), float(y))
  edges = []
  for j in range(len(ys)):
    for i in range(len(xs) - 1):
      edges.append(EdgeSpec("g{}_{}".format(i, j), "g{}_{}".format(i + 1, j),
                            speed=speed, feature=feature))
  for i in range(len(xs)):
    for j in range(len(ys) - 1):
      edges.append(EdgeSpec("g{}_{}".format(i, j), "g{}_{}".format(i, j + 1),
                            speed=speed, feature=feature))
  return NetworkSpec(nodes=nodes, edges=edges)


def build_grid_town(name: str, xs: Sequence[float],
                    ys: Sequence[float]) -> TownMap:
  """Builds a TownMap for a rectangular grid of two-lane streets."""
  return build_town(name, grid_spec(xs, ys))


# ---------------------------------------------------------------------------
# Spawn pinning
# ---------------------------------------------------------------------------


def apply_spawn_pins(town: TownMap, pins: Mapping[int, Tuple]) -> TownMap:
  """Permutes the spawn array so that spawn index ``i`` lands at the spawn
  point nearest ``pins[i]`` — used to align benchmark task (origin,
  destination) indices with the geometry their family names demand
  (Roundabouts* across the ring, Hills* along the switchback, ...).

  Pin values are ``(x, y)`` or ``(x, y, yaw_deg)``; with a yaw, only spawn
  points whose lane heading is within ~70 degrees qualify — lanes are
  directed, so e.g. a roundabout-approach origin must sit on the lane
  *toward* the ring or the BFS route will detour around it.

  Pins are applied greedily in index order; each source spawn is used at
  most once.
  """
  spawn_wp = town.spawn_wp.copy()
  spawn_edge = (town.spawn_edge.copy()
                if town.spawn_edge is not None else None)
  pos = town.wp_xy[spawn_wp]
  yaw = town.wp_yaw[spawn_wp]
  taken = np.zeros(len(spawn_wp), dtype=bool)
  for index in sorted(pins):
    pin = np.asarray(pins[index], dtype=np.float64)
    d = np.linalg.norm(pos - pin[None, :2], axis=1)
    if pin.shape[0] > 2:
      want = np.deg2rad(pin[2])
      d = np.where(np.cos(yaw - want) > 0.35, d, np.inf)
    d[taken] = np.inf
    j = int(np.argmin(d))
    if not np.isfinite(d[j]):
      raise ValueError("No spawn satisfies pin {} -> {}".format(index,
                                                                pins[index]))
    if j != index:
      for arr in (spawn_wp, pos, yaw) + (
          (spawn_edge,) if spawn_edge is not None else ()):
        arr[[index, j]] = arr[[j, index]]
    taken[index] = True
  return dataclasses.replace(town, spawn_wp=spawn_wp, spawn_edge=spawn_edge)
