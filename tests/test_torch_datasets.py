"""oatomobile_torch.datasets.carla (packed collection and the loaders)
against oatomobile_tpu.datasets.carla on the CPU.

Collection runs at the JAX package's own test size
(``tests/test_datasets_extra.py``: Town02, 2 episodes of 120 steps, a
window every 10 steps, seed 21) on both routes and with the pack-time
resize, with its tolerances: packed uint8 images within 1 count (a value
on a rounding boundary may round either way), floats within 1e-3.  The
loaders run on one synthetic pack on both sides and must give equal
batches.
"""

import json
import os

import numpy as np
import pytest
import torch

from oatomobile_torch.datasets import carla as tcarla
from oatomobile_torch.models import transforms as ttransforms
from oatomobile_tpu.datasets import carla as jcarla

torch.set_num_threads(1)

KWARGS = dict(num_episodes=2, num_steps=120, num_frame_skips=10, seed=21)
ROUTES = {"device": dict(device_pack=True),
          "host": dict(device_pack=False),
          "image_size": dict(device_pack=True, image_size=(100, 100))}


def read_pack(path: str) -> dict:
  with open(os.path.join(path, "manifest.json")) as fp:
    manifest = json.load(fp)
  arrays = {key: np.load(os.path.join(path, key + ".npy"))
            for key in manifest["modalities"]}
  return {"manifest": manifest, "arrays": arrays}


def assert_packs_match(got: dict, want: dict) -> None:
  assert got["manifest"] == want["manifest"]
  for key, a in want["arrays"].items():
    b = got["arrays"][key]
    assert a.shape == b.shape and a.dtype == b.dtype, key
    if a.dtype == np.uint8:
      assert np.abs(a.astype(int) - b.astype(int)).max() <= 1, key
    else:
      np.testing.assert_allclose(b, a, rtol=0, atol=1e-3, err_msg=key)


@pytest.fixture(scope="module")
def packs(tmp_path_factory):
  """The packs of every route, collected by each package."""
  out = {}
  for route, kwargs in ROUTES.items():
    for name, dataset, extra in (("jax", jcarla.CARLADataset, {}),
                                 ("torch", tcarla.CARLADataset,
                                  {"device": "cpu"})):
      path = str(tmp_path_factory.mktemp("{}_{}".format(name, route)))
      n = dataset.collect_packed("Town02", path, **KWARGS, **kwargs, **extra)
      assert n > 0
      out[name, route] = read_pack(path)
  return out


@pytest.mark.parametrize("signed", [True, False])
def test_derive_mode_labels_match(signed):
  rs = np.random.RandomState(0)
  future = rs.normal(0, 10, (256, 80, 3)).astype(np.float32)
  future[:5, -1, :2] = [[20.0, 0.0], [1.0, 1.0], [15.0, 10.0],
                        [15.0, -10.0], [0.5, 20.0]]
  want = jcarla.derive_mode_labels(future, signed=signed)
  got = tcarla.derive_mode_labels(future, signed=signed)
  assert got.dtype == want.dtype and got.shape == (256, 1)
  np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_collect_packed_matches_jax(route, packs):
  assert_packs_match(packs["torch", route], packs["jax", route])
  if route == "image_size":
    lidar = packs["torch", route]["arrays"]["lidar"]
    assert lidar.shape[1:3] == (100, 100) and lidar.dtype == np.uint8


def test_device_pack_matches_host_pack(packs):
  # float32 on the device against float64 numpy on the host.
  assert_packs_match(packs["torch", "device"], packs["torch", "host"])


def test_pack_image_size_matches_trainer_transform(packs):
  """Packing at (100, 100) equals packing at full size and then the
  trainers' resize, to within uint8 rounding."""
  small = packs["torch", "image_size"]["arrays"]["lidar"]
  full = packs["torch", "device"]["arrays"]["lidar"]
  nchw = torch.from_numpy(full).float().div(255.0).permute(0, 3, 1, 2)
  resized = ttransforms.downsample_visual_features(nchw, (100, 100))
  want = torch.clamp(torch.round(resized * 255.0), 0, 255).to(
      torch.uint8).permute(0, 2, 3, 1).numpy()
  assert np.abs(small.astype(int) - want.astype(int)).max() <= 1


# -- loaders over one synthetic pack ---------------------------------------------


def synthetic_pack(path: str, n: int = 37, seed: int = 0,
                   quantize: bool = True) -> str:
  """A pack of ``n`` samples with the collection's modalities; some
  samples stand still while their future leaves (restarts)."""
  rs = np.random.RandomState(seed)
  speed = rs.uniform(0, 6, n) * (rs.uniform(size=n) < 0.6)
  future = np.cumsum(rs.uniform(0, 0.2, (n, 80, 3)), axis=1)
  stacked = {
      "lidar": rs.randint(0, 6, (n, 8, 8, 2)).astype(np.float32) / 5.0,
      "velocity": np.stack([speed, np.zeros(n), np.zeros(n)],
                           -1).astype(np.float32),
      "player_future": future.astype(np.float32),
      "is_at_traffic_light": rs.randint(0, 2, (n, 1)).astype(np.float32),
  }
  if not quantize:
    stacked["lidar"] = stacked["lidar"] * 2.0  # out of [0, 1]: stays float
  os.makedirs(path, exist_ok=True)
  quantized = tcarla._save_packed_arrays(path, stacked)  # pylint: disable=protected-access
  with open(os.path.join(path, "manifest.json"), "w") as fp:
    json.dump({"num_samples": n, "modalities": sorted(stacked),
               "quantized": quantized}, fp)
  return path


@pytest.fixture(scope="module")
def pack_dir(tmp_path_factory):
  return synthetic_pack(str(tmp_path_factory.mktemp("synthetic")))


def assert_batches_equal(got, want) -> None:
  got, want = list(got), list(want)
  assert len(got) == len(want) > 0
  for g, w in zip(got, want):
    assert sorted(g) == sorted(w)
    for key in w:
      value = g[key]
      if isinstance(value, torch.Tensor):
        value = value.numpy()
      assert value.dtype == np.asarray(w[key]).dtype, key
      np.testing.assert_array_equal(value, w[key], err_msg=key)


@pytest.mark.parametrize("options", [
    dict(shuffle=True, seed=3),
    dict(shuffle=False, drop_remainder=False),
    dict(split="train", val_fraction=0.25, seed=1, mode=True),
    dict(split="val", val_fraction=0.25, shuffle=False, dequantize=True),
    dict(mode=True, signed_mode=False, seed=5),
])
def test_as_numpy_packed_matches_jax(pack_dir, options):
  assert_batches_equal(
      tcarla.CARLADataset.as_numpy_packed(pack_dir, 4, **options),
      jcarla.CARLADataset.as_jax_packed(pack_dir, 4, **options))


@pytest.mark.parametrize("split", [None, "train", "val"])
def test_make_loader_matches_jax(pack_dir, split):
  assert_batches_equal(
      tcarla.CARLADataset.make_loader(pack_dir, (), 4, seed=2, split=split,
                                      mode=True),
      jcarla.CARLADataset.make_loader(pack_dir, (), 4, seed=2, split=split,
                                      mode=True))


@pytest.mark.parametrize("n,split,fraction", [(37, "train", 0.05),
                                              (37, "val", 0.25),
                                              (1000, "val", 0.05),
                                              (5, None, 0.05)])
def test_packed_split_indices_match(n, split, fraction):
  np.testing.assert_array_equal(
      tcarla.CARLADataset.packed_split_indices(n, split, fraction),
      jcarla.CARLADataset.packed_split_indices(n, split, fraction))


def test_restart_transition_indices_match(pack_dir):
  want = jcarla.CARLADataset.restart_transition_indices(pack_dir)
  assert len(want) > 0
  np.testing.assert_array_equal(
      tcarla.CARLADataset.restart_transition_indices(pack_dir), want)


def test_merge_packed_matches_jax(tmp_path):
  parts = [synthetic_pack(str(tmp_path / "a"), 11, 1),
           synthetic_pack(str(tmp_path / "b"), 7, 2, quantize=False)]
  n_t = tcarla.CARLADataset.merge_packed(parts, str(tmp_path / "t"))
  n_j = jcarla.CARLADataset.merge_packed(parts, str(tmp_path / "j"))
  assert n_t == n_j == 18
  got, want = read_pack(str(tmp_path / "t")), read_pack(str(tmp_path / "j"))
  assert got["manifest"] == want["manifest"]
  assert "lidar" not in got["manifest"]["quantized"]
  for key, value in want["arrays"].items():
    assert got["arrays"][key].dtype == value.dtype
    np.testing.assert_array_equal(got["arrays"][key], value, err_msg=key)


@pytest.mark.parametrize("options", [dict(seed=4),
                                     dict(shuffle=False,
                                          drop_remainder=False)])
def test_iter_device_batches_match_numpy_loader(pack_dir, options):
  data, n = tcarla.CARLADataset.load_packed_to_device(pack_dir,
                                                      device="cpu")
  assert n == 37 and data["lidar"].dtype == torch.uint8
  assert all(isinstance(v, torch.Tensor) for v in data.values())
  assert_batches_equal(
      tcarla.CARLADataset.iter_device_batches(data, np.arange(n), 5,
                                              **options),
      tcarla.CARLADataset.as_numpy_packed(pack_dir, 5, **options))
  subset, _ = tcarla.CARLADataset.load_packed_to_device(
      pack_dir, ("velocity",), device="cpu")
  assert list(subset) == ["velocity"]


def test_is_packed(pack_dir, tmp_path):
  assert tcarla.CARLADataset.is_packed(pack_dir)
  assert not tcarla.CARLADataset.is_packed(str(tmp_path))
