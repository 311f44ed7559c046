"""Per-step collection (``collect_batched``), ``process``, ``pack`` and the
per-file loaders of oatomobile_torch.datasets, and ``MultiTownBatchedEnv``,
against the JAX package on the CPU.

Episode and sample files are named by random tokens, so the two packages'
episodes are matched by their first location and their samples by their
location.  Floats within 1e-3 (the JAX package's device-against-host
tolerance); LIDAR values apart by more than 1e-6 (or uint8 counts by more
than 1) under 1e-4 of them: the port's splat and the JAX package's may
place a rect-edge pixel differently (``tests/test_torch_bev.py``).
"""

import glob
import os

import numpy as np
import pytest
import torch

from oatomobile_torch.core.dataset import Episode as TEpisode
from oatomobile_torch.datasets.carla import CARLADataset as TDataset
from oatomobile_torch.envs.multi_town import MultiTownBatchedEnv as TMulti
from oatomobile_tpu.datasets.carla import CARLADataset as JDataset
from oatomobile_tpu.envs.multi_town import MultiTownBatchedEnv as JMulti
from torch_port_helpers import fraction_beyond

torch.set_num_threads(1)

MODALITIES = ("lidar", "player_future", "player_past", "velocity",
              "location", "is_at_traffic_light")


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
  """One 2-scene, 130-step batched collection by each package, processed
  (a window every 10 steps) and packed."""
  out = {}
  for name, dataset, extra in (("jax", JDataset, {}),
                               ("torch", TDataset, {"device": "cpu"})):
    root = tmp_path_factory.mktemp(name)
    tokens = dataset.collect_batched("Town02", str(root / "raw"),
                                     num_episodes=2, num_steps=130, seed=3,
                                     **extra)
    assert len(tokens) == 2
    dataset.process(str(root / "raw"), str(root / "processed"),
                    num_frame_skips=10)
    n = dataset.pack(str(root / "processed"), str(root / "packed"),
                     MODALITIES, mode=True)
    assert n >= 4
    out[name] = root
  return out


def episodes(root) -> list:
  """Each episode's steps stacked per key, ordered by first location."""
  out = []
  for token in os.listdir(os.path.join(str(root), "raw")):
    episode = TEpisode(os.path.join(str(root), "raw"), token)
    steps = [episode.read_sample(t) for t in episode.fetch()]
    out.append({k: np.stack([s[k] for s in steps]) for k in steps[0]})
  return sorted(out, key=lambda e: tuple(e["location"][0]))


def test_collect_batched_matches_jax(raw):
  got, want = episodes(raw["torch"]), episodes(raw["jax"])
  assert len(got) == len(want) == 2
  for g, w in zip(got, want):
    assert sorted(g) == sorted(w)
    for key, value in w.items():
      assert g[key].shape == value.shape and g[key].dtype == value.dtype, key
      if key == "lidar":
        assert fraction_beyond(g[key], value, 1e-6) < 1e-4
      else:
        np.testing.assert_allclose(g[key], value, rtol=0, atol=1e-3,
                                   err_msg=key)


def packed_rows(root) -> dict:
  """The pack's arrays, rows ordered by (location, future end)."""
  path = os.path.join(str(root), "packed")
  arrays = {key: np.load(os.path.join(path, key + ".npy"))
            for key in MODALITIES + ("mode",)}
  order = np.lexsort((arrays["player_future"][:, -1, 0],
                      arrays["location"][:, 1], arrays["location"][:, 0]))
  return {key: value[order] for key, value in arrays.items()}


def test_process_and_pack_match_jax(raw):
  got, want = packed_rows(raw["torch"]), packed_rows(raw["jax"])
  for key, value in want.items():
    assert got[key].shape == value.shape and got[key].dtype == value.dtype
    if value.dtype == np.uint8:
      assert fraction_beyond(got[key].astype(int), value.astype(int),
                             1) < 1e-4, key
    else:
      np.testing.assert_allclose(got[key], value, rtol=0, atol=1e-3,
                                 err_msg=key)


def test_per_file_loaders_match_jax(raw):
  """The port's per-file loaders on the JAX package's processed files."""
  processed = str(raw["jax"] / "processed")
  fname = sorted(glob.glob(os.path.join(processed, "*.npz")))[0]
  for dataformat in ("HWC", "CHW"):
    want = JDataset.load_datum(fname, MODALITIES, True, dataformat)
    got = TDataset.load_datum(fname, MODALITIES, True, dataformat)
    assert sorted(got) == sorted(want)
    for key in MODALITIES + ("mode",):
      np.testing.assert_array_equal(got[key], want[key], err_msg=key)
  for got, want in zip(
      TDataset.as_numpy_batched(processed, MODALITIES, 2, mode=True, seed=4),
      JDataset.as_jax(processed, MODALITIES, 2, mode=True, seed=4)):
    for key in want:
      np.testing.assert_array_equal(got[key], want[key], err_msg=key)
  want = list(JDataset.as_numpy(processed, ("velocity",)))
  got = list(TDataset.as_numpy(processed, ("velocity",)))
  assert [g["name"] for g in got] == [w["name"] for w in want]
  ds = TDataset.as_torch(processed, ("velocity", "lidar"), mode=True)
  ref = JDataset.as_torch(processed, ("velocity", "lidar"), mode=True)
  assert isinstance(ds, torch.utils.data.Dataset) and len(ds) == len(ref)
  for key, value in ref[0].items():
    np.testing.assert_array_equal(ds[0][key], value, err_msg=key)
  assert ds[0]["lidar"].shape == (2, 200, 200)


def test_multi_town_matches_jax():
  towns, steps = ("Town01", "Town02"), 20
  jenv = JMulti(towns, batch_size=4, num_vehicles=2, seed=7)
  tenv = TMulti(towns, batch_size=4, num_vehicles=2, seed=7, device="cpu")
  assert tenv.towns == list(towns) and tenv.batch_size == 4
  _, jcol, jstats = jenv.rollout(steps, collect=("location",))
  _, tcol, tstats = tenv.rollout(steps, collect=("location",))
  for key in ("episodes", "collisions"):
    np.testing.assert_array_equal(tstats[key].numpy(), np.asarray(jstats[key]))
  np.testing.assert_allclose(tstats["distance"].numpy(),
                             np.asarray(jstats["distance"]), rtol=0,
                             atol=1e-3)
  assert tcol["location"].shape == (steps, 4, 3)
  np.testing.assert_allclose(tcol["location"].numpy(),
                             np.asarray(jcol["location"]), rtol=0, atol=1e-3)
  obs = tenv.reset()
  assert obs["location"].shape == (4, 3)
  obs, done = tenv.step(np.tile([[0.5, 0.0, 0.0]], (4, 1)))
  assert done.shape == (4,) and obs["velocity"].shape == (4, 3)
  with pytest.raises(ValueError):
    TMulti(towns, batch_size=3, device="cpu")
