"""The BEV splat kernel's culling and test math on the CPU.

``oatomobile_torch/csrc/bev_splat_tile.cuh`` holds the kernel's per-slot
and per-pixel math as ``__host__ __device__`` functions.  Here g++ builds it
through the small C harness ``csrc/bev_splat_tile_host.cc`` (plain float
operations, ``-ffp-contract=off``), and the tests check that

  - a slot's pixel box is conservative: every pixel that the exact test
    marks inside lies in the box, on seeded random inputs and on edge cases
    (0, 45 and 90 degree rects, rects straddling each image edge, larger
    than the image, wholly off it, an edge exactly on a pixel centre, every
    slot live);
  - the header's cu/cv and inside-test equal the plain version's bit for
    bit;
  - the tiled algorithm, which tests a pixel only against the slots whose
    box meets its 8 x 40 tile, equals ``splat_lidar_batch_reference`` bit
    for bit: as a numpy model and as the harness's host run of the kernel's
    loop.
"""

import ctypes
import os
import shutil
import subprocess
import tempfile

import numpy as np
import pytest
import torch

from oatomobile_torch import paths
from oatomobile_torch import sim as tsim
from oatomobile_torch.maps import load_town
from oatomobile_torch.ops import bev, bev_cuda

torch.set_num_threads(1)

HARNESS = os.path.join(bev_cuda.CSRC, "bev_splat_tile_host.cc")
LIBRARY = os.path.join(paths.BUILD_DIR, "kernels",
                       "libbev_splat_tile_host.so")
BEV = bev.BEV_SIZE
TILE_ROWS, TILE_COLS = 8, 40  # csrc/bev_splat_tile.cuh

# (town, vehicles, pedestrians, steps of motion, seed): the cases of
# tests/test_torch_bev.py, here driven by the port's own world step.
CASES = [("Town02", 0, 0, 0, 7), ("Town02", 6, 3, 0, 7),
         ("Town02", 4, 0, 25, 9), ("Town03", 8, 4, 20, 11)]


def _ptr(array: np.ndarray):
  return array.ctypes.data_as(ctypes.c_void_p)


@pytest.fixture(scope="module")
def harness():
  """The header built by g++ into the build directory, loaded with
  ctypes."""
  gxx = shutil.which("g++")
  if gxx is None:
    pytest.skip("needs g++ to build csrc/bev_splat_tile_host.cc")
  sources = (HARNESS, *bev_cuda.HEADERS)
  if not (os.path.exists(LIBRARY) and os.path.getmtime(LIBRARY) >= max(
      os.path.getmtime(s) for s in sources)):
    os.makedirs(os.path.dirname(LIBRARY), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(LIBRARY))
    os.close(fd)
    proc = subprocess.run(
        [gxx, "-O2", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC",
         "-I", bev_cuda.CSRC, "-o", tmp, HARNESS],
        capture_output=True, text=True, check=False)
    if proc.returncode != 0:
      os.unlink(tmp)
      raise RuntimeError(proc.stdout + proc.stderr)
    os.replace(tmp, LIBRARY)
  lib = ctypes.CDLL(LIBRARY)
  ptr, i32 = ctypes.c_void_p, ctypes.c_int
  lib.bev_tile_boxes.argtypes = [ptr, ptr, i32, i32, ptr, ptr]
  lib.bev_tile_boxes.restype = None
  lib.bev_tile_inside.argtypes = [ptr, ptr, i32, i32, ptr, ptr]
  lib.bev_tile_inside.restype = None
  lib.bev_tile_constants.argtypes = [ptr, i32, ptr, ptr]
  lib.bev_tile_constants.restype = None
  lib.bev_tile_splat.argtypes = [ptr, ptr, i32, ptr, i32, ptr, i32, ptr, ptr,
                                 ptr, ptr, i32]
  lib.bev_tile_splat.restype = ctypes.c_longlong
  return lib


def _np(x: torch.Tensor) -> np.ndarray:
  return np.ascontiguousarray(x.numpy(), dtype=np.float32)


def _centers() -> np.ndarray:
  return _np(bev.pixel_centers(torch.device("cpu")))


def boxes_of(lib, hero: np.ndarray, rects: np.ndarray):
  """(boxes [B, m, 4] int32, live [B, m] bool) from the header."""
  B, m = rects.shape[:2]
  boxes = np.zeros((B, m, 4), np.int32)
  live = np.zeros((B, m), np.uint8)
  lib.bev_tile_boxes(_ptr(hero), _ptr(rects), B, m, _ptr(boxes), _ptr(live))
  return boxes, live.astype(bool)


def inside_of(lib, hero: np.ndarray, rects: np.ndarray) -> np.ndarray:
  """[B, m, 200, 200] bool: the header's exact test."""
  B, m = rects.shape[:2]
  inside = np.zeros((B, m, BEV, BEV), np.uint8)
  lib.bev_tile_inside(_ptr(hero), _ptr(rects), B, m, _ptr(_centers()),
                      _ptr(inside))
  return inside.astype(bool)


def _rects_of(inputs):
  """[B, 96, 6] numpy: walls, roads and boxes side by side."""
  _, walls, roads, boxes = inputs
  return _np(torch.cat([walls, roads, boxes], dim=1))


def _scene_inputs(town, vehicles, pedestrians, steps, seed):
  params = tsim.make_params(load_town(town), device="cpu")
  state = tsim.init_scene_batch(load_town(town), 3,
                                num_vehicles=vehicles,
                                num_pedestrians=pedestrians, seed=seed,
                                device="cpu")
  actions = torch.tensor([[0.8, 0.3, 0.0]]).repeat(3, 1)
  for _ in range(steps):
    state = tsim.world_step(params, state, actions)
  return bev.gather_inputs(params, state)


EXACT_PIXELS = ((37, 120), (150, 3), (0, 199), (100, 100))


def _edge_inputs(yaw_deg: float, hero_xy=(0.0, 0.0), marks=None):
  """One scene of hand-made edge cases around a hero at ``hero_xy``, every
  slot of the 96 filled.  ``marks``, where given, receives the slot index
  of the rect larger than the image ("huge") and of the rects with an edge
  exactly on a pixel centre ("exact": (slot, row, col))."""
  yaw = np.deg2rad(np.float32(yaw_deg))
  c, s = np.float32(np.cos(yaw)), np.float32(np.sin(yaw))
  hero = np.array([[hero_xy[0], hero_xy[1], c, s]], np.float32)
  centers = _centers().astype(np.float64)
  rects = []
  marks = {} if marks is None else marks

  def add(lx, ly, hl, hw, angle_deg=None, axis=None):
    # A rect centred at hero-frame (lx, ly), its axis given in the world
    # frame by an angle or by an exact (cos, sin) pair.
    wx = hero_xy[0] + c * lx - s * ly
    wy = hero_xy[1] + s * lx + c * ly
    if axis is None:
      a = np.deg2rad(angle_deg)
      axis = (np.cos(a), np.sin(a))
    rects.append([wx, wy, hl, hw, axis[0], axis[1]])

  for axis in ((1.0, 0.0), (0.70710677, 0.70710677), (0.0, 1.0)):
    add(3.0, -7.0, 6.0, 1.5, axis=axis)       # 0, 45, 90 degrees
    add(-30.0, 20.0, 0.3, 0.3, axis=axis)     # smaller than a pixel
  for lx, ly in ((-50.2, 5.0), (51.1, -5.0), (5.0, -50.0), (-5.0, 51.3)):
    add(lx, ly, 2.0, 1.0, angle_deg=30.0)     # straddling each edge
    add(lx, ly, 0.2, 0.2, angle_deg=0.0)
  marks["huge"] = len(rects)
  add(0.0, 0.0, 300.0, 250.0, angle_deg=10.0)  # larger than the image
  add(40.0, 0.0, 500.0, 0.5, angle_deg=70.0)   # a strip across it
  for lx, ly in ((-80.0, 0.0), (0.0, 95.0), (75.0, 75.0), (-1e4, 3e4)):
    add(lx, ly, 3.0, 3.0, angle_deg=45.0)     # wholly off the image
  for _ in range(4):                           # empty slots
    rects.append([-1e6, -1e6, 0.0, 0.0, 1.0, 0.0])
  rects.append([hero_xy[0], hero_xy[1], -1.0, 2.0, 1.0, 0.0])
  # An edge exactly on a pixel centre: |u| of pixel (i, j), by the exact
  # arithmetic, is the half-length (and |v| the half-width, or 2 m more)
  # of a rect centred near it.
  wx, wy = bev_cuda.pixel_world(torch.tensor(hero))
  marks["exact"] = []
  for (i, j), angle in zip(EXACT_PIXELS, (0.0, 45.0, 90.0, 17.0)):
    add(centers[i] + 0.9, centers[j] - 1.3, 1.0, 1.0, angle_deg=angle)
    r = torch.tensor(np.array(rects[-1:], np.float32))
    u, v, _, _ = bev_cuda._rect_uv(r, wx[:, i, j], wy[:, i, j])  # pylint: disable=protected-access
    rects[-1][2], rects[-1][3] = float(u.abs()), float(v.abs())
    rects.append(list(rects[-1]))
    rects[-1][3] += 2.0
    marks["exact"] += [(len(rects) - 2, i, j), (len(rects) - 1, i, j)]
  rects = np.array(rects, np.float32)
  rects = np.concatenate(
      [rects, np.tile(rects[:1], (96 - len(rects), 1))])[None]
  hero_t, rects_t = torch.tensor(hero), torch.tensor(rects)
  return (hero_t, rects_t[:, :32].contiguous(),
          rects_t[:, 32:56].contiguous(), rects_t[:, 56:].contiguous())


INPUTS = {
    "stress-seed0": lambda: bev_cuda.stress_inputs(6, 0, "cpu"),
    "stress-seed1": lambda: bev_cuda.stress_inputs(6, 1, "cpu"),
    "stress-seed2": lambda: bev_cuda.stress_inputs(6, 2, "cpu"),
    "edges-yaw0": lambda: _edge_inputs(0.0),
    "edges-yaw45": lambda: _edge_inputs(45.0, (117.0, -42.5)),
    "edges-yaw90-far": lambda: _edge_inputs(90.0, (2.5e4, -1.25e4)),
    "edges-yaw-133": lambda: _edge_inputs(-133.0, (-301.7, 88.2)),
}


@pytest.fixture(scope="module", params=sorted(INPUTS))
def stress(request):
  return INPUTS[request.param]()


@pytest.fixture(scope="module", params=CASES,
                ids=lambda c: "{}-{}v-{}p-{}s".format(*c[:4]))
def scene_inputs(request):
  return _scene_inputs(*request.param)


def _assert_boxes_conservative(lib, inputs):
  hero = _np(inputs[0])
  rects = _rects_of(inputs)
  boxes, live = boxes_of(lib, hero, rects)
  inside = inside_of(lib, hero, rects)
  rows = np.arange(BEV)[:, None]
  cols = np.arange(BEV)[None, :]
  hits = 0
  for b, k in zip(*np.nonzero(inside.any(axis=(2, 3)))):
    assert live[b, k], (b, k, rects[b, k])
    r0, r1, c0, c1 = boxes[b, k]
    in_box = (rows >= r0) & (rows <= r1) & (cols >= c0) & (cols <= c1)
    outside = inside[b, k] & ~in_box
    assert not outside.any(), (b, k, rects[b, k], boxes[b, k],
                               np.argwhere(outside)[:5])
    hits += 1
  # Empty slots are never live; a live slot's box lies on the image.
  assert not (live & ~(rects[..., 2] > 0)).any()
  assert ((boxes[live] >= 0) & (boxes[live] < BEV)).all()
  return hits, live


def test_slot_boxes_are_conservative(harness, stress):
  hits, live = _assert_boxes_conservative(harness, stress)
  assert hits > 0
  # Culling drops something: not every live slot covers the whole image.
  boxes, _ = boxes_of(harness, _np(stress[0]), _rects_of(stress))
  area = ((boxes[..., 1] - boxes[..., 0] + 1) *
          (boxes[..., 3] - boxes[..., 2] + 1))[live]
  assert (area < BEV * BEV).any()


def test_slot_boxes_are_conservative_on_scenes(harness, scene_inputs):
  hits, _ = _assert_boxes_conservative(harness, scene_inputs)
  assert hits > 0


@pytest.mark.parametrize("yaw,hero_xy", [(0.0, (0.0, 0.0)),
                                          (-133.0, (-301.7, 88.2))])
def test_edge_cases_hold_pixels_on_the_edge(harness, yaw, hero_xy):
  """A rect whose edge passes exactly through a pixel centre marks that
  pixel inside; the rect larger than the image marks every pixel."""
  marks = {}
  inputs = _edge_inputs(yaw, hero_xy, marks)
  inside = inside_of(harness, _np(inputs[0]), _rects_of(inputs))[0]
  assert inside[marks["huge"]].all()
  for k, i, j in marks["exact"]:
    assert inside[k, i, j], (k, i, j)


def _plain_constants(rects: np.ndarray):
  r = torch.tensor(rects)
  cx, cy, _, _, cr, sr = r.unbind(-1)
  return _np(cr * cx + sr * cy), _np(-sr * cx + cr * cy)


def _check_header_matches_plain(lib, inputs):
  hero = _np(inputs[0])
  rects = _rects_of(inputs)
  n = rects.shape[0] * rects.shape[1]
  cu = np.zeros(n, np.float32)
  cv = np.zeros(n, np.float32)
  lib.bev_tile_constants(_ptr(rects), n, _ptr(cu), _ptr(cv))
  want_cu, want_cv = _plain_constants(rects)
  np.testing.assert_array_equal(cu, want_cu.reshape(-1))
  np.testing.assert_array_equal(cv, want_cv.reshape(-1))
  inside = inside_of(lib, hero, rects)
  wx, wy = bev_cuda.pixel_world(inputs[0])
  for k in range(rects.shape[1]):
    want = bev_cuda.rect_inside(torch.tensor(rects[:, k]), wx, wy).numpy()
    np.testing.assert_array_equal(inside[:, k], want, err_msg=str(k))


def test_header_math_matches_plain_version(harness, stress):
  _check_header_matches_plain(harness, stress)


def test_header_math_matches_plain_version_on_scenes(harness, scene_inputs):
  _check_header_matches_plain(harness, scene_inputs)


def tiled_model(lib, hero, walls, roads, boxes) -> np.ndarray:
  """numpy model of the kernel's tiled splat: per 8 x 40 tile, only the
  slots whose header box meets the tile are tested, with the plain
  version's float32 arithmetic; roads only where not occupied."""
  hero, walls, roads, boxes = (_np(x) for x in (hero, walls, roads, boxes))
  counts, ground = bev.const_images()
  centers = _centers()
  occ_rects = np.concatenate([walls, boxes], axis=1)
  out = np.zeros((hero.shape[0], BEV, BEV, 2), np.float32)
  lists = []
  for rects in (occ_rects, roads):
    box, live = boxes_of(lib, hero, rects)
    cu, cv = _plain_constants(rects)
    lists.append((rects, box, live, cu, cv))
  for b in range(hero.shape[0]):
    hx, hy, cos_y, sin_y = hero[b]
    for tr0 in range(0, BEV, TILE_ROWS):
      for tc0 in range(0, BEV, TILE_COLS):
        tr1, tc1 = tr0 + TILE_ROWS - 1, tc0 + TILE_COLS - 1
        lx = centers[tr0:tr1 + 1, None]
        ly = centers[None, tc0:tc1 + 1]
        wx = hx + cos_y * lx - sin_y * ly
        wy = hy + sin_y * lx + cos_y * ly
        hits = []
        for rects, box, live, cu, cv in lists:
          hit = np.zeros(wx.shape, bool)
          for k in np.nonzero(live[b])[0]:
            r0, r1, c0, c1 = box[b, k]
            if r0 > tr1 or r1 < tr0 or c0 > tc1 or c1 < tc0:
              continue
            _, _, hl, hw, cr, sr = rects[b, k]
            u = cr * wx + sr * wy - cu[b, k]
            v = cr * wy - sr * wx - cv[b, k]
            hit |= (np.abs(u) <= hl) & (np.abs(v) <= hw)
          hits.append(hit)
        occupied, is_open = hits
        tile = (slice(tr0, tr1 + 1), slice(tc0, tc1 + 1))
        out[b][tile + (0,)] = np.where(is_open & ~occupied, ground[tile], 0)
        out[b][tile + (1,)] = np.where(occupied, counts[tile], 0)
  return out


def test_tiled_model_matches_reference_on_scenes(harness, scene_inputs):
  want = bev_cuda.splat_lidar_batch_reference(*scene_inputs).numpy()
  np.testing.assert_array_equal(tiled_model(harness, *scene_inputs), want)


def test_tiled_model_matches_reference_on_stress(harness, stress):
  want = bev_cuda.splat_lidar_batch_reference(*stress).numpy()
  np.testing.assert_array_equal(tiled_model(harness, *stress), want)


def host_splat(lib, hero, walls, roads, boxes):
  """(out, tests): the harness's host run of the kernel's loop."""
  hero, walls, roads, boxes = (_np(x) for x in (hero, walls, roads, boxes))
  counts, ground = bev.const_images()
  out = np.zeros((hero.shape[0], BEV, BEV, 2), np.float32)
  tests = lib.bev_tile_splat(
      _ptr(hero), _ptr(walls), walls.shape[1], _ptr(roads), roads.shape[1],
      _ptr(boxes), boxes.shape[1], _ptr(_centers()), _ptr(counts),
      _ptr(ground), _ptr(out), hero.shape[0])
  return out, tests


def test_host_splat_matches_reference_and_culls(harness, scene_inputs):
  out, tests = host_splat(harness, *scene_inputs)
  want = bev_cuda.splat_lidar_batch_reference(*scene_inputs).numpy()
  np.testing.assert_array_equal(out, want)
  # Culling: far fewer pixel-slot tests than the dense count.
  dense = BEV * BEV * sum(int((x[..., 2] > 0).sum())
                          for x in scene_inputs[1:])
  assert tests < dense / 3, (tests, dense)


def test_host_splat_matches_reference_on_stress(harness, stress):
  out, _ = host_splat(harness, *stress)
  want = bev_cuda.splat_lidar_batch_reference(*stress).numpy()
  np.testing.assert_array_equal(out, want)
