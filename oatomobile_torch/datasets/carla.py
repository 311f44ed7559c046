"""Expert demonstration dataset pipeline: the port of the JAX package's
``datasets/carla.py`` (``CARLADataset``).

Autopilot collection (one scene through the gym API, or a batch of scenes
through ``BatchedEnv``), raw -> processed windowing (past 20 / future 80 /
skip 5, ego frame), the packed uint8 training format, and loaders.
``collect_packed`` windows, ego-frames and quantises a rollout on the
device (``_device_pack_windows``) and fetches only the training-ready
arrays; ``load_packed_to_device`` and ``iter_device_batches`` keep a pack
resident in device memory and gather batches there.

Renamed from the JAX package (they yield numpy batches and never touched
jax): ``as_jax_packed`` is ``as_numpy_packed`` and ``as_jax`` is
``as_numpy_batched``.  ``load_packed_to_device`` returns torch tensors and
uploads each array in one pinned copy (the JAX package's 1 GiB chunking
was a workaround for its accelerator's link).
"""

import glob
import json
import os
import sys
import zipfile
from typing import Any, Callable, Generator, Mapping, Optional, Sequence

import numpy as np
import torch

from oatomobile_torch import device as device_lib
from oatomobile_torch.core.dataset import Dataset, Episode
from oatomobile_torch.ops import transforms as tf_ops

# Image modalities eligible for uint8 packing.  An explicit allowlist, not
# a value-range heuristic: a [N,T,2] trajectory of a mostly-stationary run
# can land in [0,1] by accident and must never be rounded to a 1/255 grid
# (and per-shard min/max decisions could make shards disagree on dtype).
_QUANTIZABLE_MODALITIES = frozenset({
    "lidar", "bird_view_camera_rgb", "bird_view_camera_cityscapes",
    "front_camera_rgb", "rear_camera_rgb", "left_camera_rgb",
    "right_camera_rgb", "game_state",
})


def derive_mode_labels(player_future: np.ndarray,
                       signed: bool = True) -> np.ndarray:
  """Vectorised {0 FORWARD, 1 STOP, 2 LEFT, 3 RIGHT} command labels from
  future-trajectory endpoints ``[N, T, >=2]``.

  ``signed`` (default) labels by the signed angle of the endpoint, the
  rule of the evaluation-time CIL policy (``cil.policy.mode_from_goal``):
  +y is the right-hand side.  ``signed=False`` is the reference dataset's
  rule, ``theta = degrees(arccos(x/r)) >= 0``, under which RIGHT is
  unreachable and both turn directions label as LEFT.
  """
  end = np.asarray(player_future)[:, -1, :2]
  norm = np.linalg.norm(end, axis=-1)
  if signed:
    theta = np.degrees(np.arctan2(end[:, 1], end[:, 0]))
    m = np.where(theta > 15, 3, np.where(theta < -15, 2, 0))
  else:
    theta = np.degrees(np.arccos(end[:, 0] / (norm + 1e-3)))
    m = np.where(theta > 15, 2, np.where(theta <= -15, 3, 0))
  return np.where(norm < 3, 1, m)[:, None].astype(np.float32)


def _save_packed_arrays(output_dir: str, stacked) -> list:
  """Saves stacked arrays; allowlisted image modalities in [0, 1] are
  stored as uint8 (error bound 1/510; the BEV below-channel's six discrete
  levels are exact).  Returns the list of quantised keys."""
  quantized = []
  for key, arr in stacked.items():
    if (key in _QUANTIZABLE_MODALITIES and arr.dtype == np.float32 and
        float(arr.min()) >= 0.0 and float(arr.max()) <= 1.0):
      arr = np.round(arr * 255.0).astype(np.uint8)
      quantized.append(key)
    elif key in _QUANTIZABLE_MODALITIES and arr.dtype == np.uint8:
      # Already quantised on the device (`_device_pack_windows`).
      quantized.append(key)
    np.save(os.path.join(output_dir, "{}.npy".format(key)), arr)
  return quantized


def _resize_quantize(value: torch.Tensor, image_size) -> torch.Tensor:
  """``[..., H, W, C]`` images in [0, 1] -> ``[..., h, w, C]`` uint8: the
  models' antialiased bilinear resize (``models.transforms``, NCHW inside),
  then ``clip(round(x * 255))``."""
  from oatomobile_torch.models import transforms  # pylint: disable=import-outside-toplevel
  if image_size is not None:
    nchw = value.to(torch.float32).movedim(-1, -3)
    value = transforms.downsample_visual_features(
        nchw, tuple(image_size)).movedim(-3, -1)
  return torch.clamp(torch.round(value.to(torch.float32) * 255.0), 0,
                     255).to(torch.uint8)


def _device_pack_windows(collected, modalities, past_length, future_length,
                         num_frame_skips, image_size=None):
  """Windows, ego-frames and quantises a rollout on its device.

  Only the training-ready arrays leave the device: window centres every
  ``num_frame_skips`` steps, images as uint8.

  Args:
    collected: dict of tensors ``[T, B, ...]`` from ``BatchedEnv.rollout``;
      must contain ``location``, ``rotation`` and ``collision`` plus
      ``modalities``.
    modalities: keys to gather at window centres.

  Returns:
    dict of tensors ``[C, B, ...]`` (C window centres): ``player_past`` /
    ``player_future`` ego-frame float32, ``location`` / ``rotation``, each
    modality (allowlisted images as uint8), and a bool ``valid`` mask
    (windows that reach the first collision frame are invalid: post-crash
    frames teach models to park).
  """
  loc = collected["location"]            # [T, B, 3]
  rot = collected["rotation"]            # [T, B, 3]
  T, device = loc.shape[0], loc.device
  centers_np = np.arange(past_length, T - future_length, num_frame_skips)
  centers = torch.as_tensor(centers_np, device=device)

  collided = collected["collision"] > 0  # [T, B]
  first = collided.to(torch.uint8).argmax(dim=0)
  crash_t = torch.where(collided.any(dim=0), first,
                        torch.full_like(first, T))                 # [B]
  valid = (centers[:, None] + future_length) < crash_t[None, :]    # [C, B]

  # Window gathers with static index grids: [C, W, B, 3] -> [C, B, W, 3].
  past_idx = torch.as_tensor(
      centers_np[:, None] + np.arange(-past_length, 0)[None, :],
      device=device)
  fut_idx = torch.as_tensor(
      centers_np[:, None] + np.arange(1, future_length + 1)[None, :],
      device=device)
  cur_loc = loc[centers].to(torch.float32)                       # [C, B, 3]
  cur_rot = rot[centers].to(torch.float32)
  past_w = loc[past_idx].permute(0, 2, 1, 3).to(torch.float32)
  fut_w = loc[fut_idx].permute(0, 2, 1, 3).to(torch.float32)
  player_past = tf_ops.world2local(current_location=cur_loc,
                                   current_rotation=cur_rot,
                                   world_locations=past_w)
  player_future = tf_ops.world2local(current_location=cur_loc,
                                     current_rotation=cur_rot,
                                     world_locations=fut_w)

  out = {"player_past": player_past, "player_future": player_future,
         "location": cur_loc, "rotation": cur_rot, "valid": valid}
  for key in modalities:
    value = collected[key][centers]                              # [C, B, ...]
    if value.dim() == 2:
      value = value[..., None]  # as the host path's np.atleast_1d
    if key in _QUANTIZABLE_MODALITIES:
      if value.dtype != torch.uint8:
        # Allowlisted images are in [0, 1] (the BEV splat clips to 5
        # points a pixel and divides by 5); the clip only guards rounding.
        value = _resize_quantize(
            value, image_size if value.dim() >= 4 else None)
      # uint8 already: resized and quantised by the rollout's
      # collect_transform, a pure gather here.
    else:
      # The host path casts every modality to float32: keep the on-disk
      # dtypes of both paths identical.
      value = value.to(torch.float32)
    out[key] = value
  return out


def _prefetch_iterator(iterator, depth: int):
  """Runs `iterator` in a daemon thread, buffering `depth` items."""
  import queue  # pylint: disable=import-outside-toplevel
  import threading  # pylint: disable=import-outside-toplevel

  q: "queue.Queue" = queue.Queue(maxsize=depth)
  sentinel = object()

  def worker():
    try:
      for item in iterator:
        q.put(item)
    finally:
      q.put(sentinel)

  threading.Thread(target=worker, daemon=True).start()
  while True:
    item = q.get()
    if item is sentinel:
      return
    yield item


def _noisy_autopilot(noise: float):
  """The rollout policy of the expert with epsilon-noise ``noise`` (None,
  the rollout's own autopilot, when it is 0)."""
  if noise <= 0.0:
    return None
  from oatomobile_torch.sim import autopilot_policy  # pylint: disable=import-outside-toplevel

  def policy(params, states):
    return autopilot_policy(params, states, noise=noise)

  return policy


class CARLADataset(Dataset):
  """The autopilot expert demonstrations dataset."""

  def __init__(self, id: str) -> None:  # pylint: disable=redefined-builtin
    if id not in ("raw", "examples", "processed"):
      raise ValueError("Unrecognised CARLA dataset id {}".format(id))
    self.id = id
    super().__init__()

  def _get_uuid(self) -> str:
    return "CARLATown01Autopilot{}-v0".format(self.id)

  @property
  def info(self) -> Mapping[str, Any]:
    return dict(
        uuid=self.uuid,
        town="Town01",
        agent="oatomobile_torch.baselines.rulebased.AutopilotAgent",
        noise=0.2,
    )

  @property
  def url(self) -> str:
    """Hosted URL of the reference dataset."""
    return ("https://www.cs.ox.ac.uk/people/angelos.filos/data/"
            "oatomobile/{}.zip".format(self.id))

  def download_and_prepare(self, output_dir: str) -> None:
    """Downloads and extracts the hosted dataset.

    Requires network access; without it use :meth:`collect`,
    :meth:`collect_batched` or :meth:`collect_packed` to generate
    demonstrations locally instead.
    """
    import urllib.request  # pylint: disable=import-outside-toplevel
    os.makedirs(output_dir, exist_ok=True)
    zfname = os.path.join(output_dir, "{}.zip".format(self.id))
    urllib.request.urlretrieve(self.url, zfname)
    with zipfile.ZipFile(zfname) as zfile:
      zfile.extractall(output_dir)
    os.remove(zfname)

  # -- loading -----------------------------------------------------------

  @staticmethod
  def load_datum(
      fname: str,
      modalities: Sequence[str],
      mode: bool,
      dataformat: str = "HWC",
      signed_mode: bool = False,
  ) -> Mapping[str, np.ndarray]:
    """Loads a single ``.npz`` datum.

    The ``mode`` label {0 FORWARD, 1 STOP, 2 LEFT, 3 RIGHT} follows the
    reference dataset's rule by default (``derive_mode_labels(...,
    signed=False)``); ``signed_mode=True`` gives the trainers' rule.
    """
    assert dataformat in ("HWC", "CHW")
    dtype = np.float32
    sample = dict()

    with np.load(fname) as datum:
      for attr in modalities:
        value = np.atleast_1d(datum[attr]).astype(dtype)
        if value.ndim == 3 and dataformat == "CHW":
          value = np.transpose(value, (2, 0, 1))
        sample[attr] = value

    if mode and "player_future" in sample:
      sample["mode"] = derive_mode_labels(
          sample["player_future"][None], signed=signed_mode)[0]

    sample["name"] = fname
    return sample

  # -- collection -----------------------------------------------------------

  @staticmethod
  def collect(
      town: str,
      output_dir: str,
      num_vehicles: int,
      num_pedestrians: int,
      num_steps: int = 1000,
      spawn_point: Optional[int] = None,
      destination: Optional[int] = None,
      sensors: Sequence[str] = (
          "acceleration",
          "velocity",
          "lidar",
          "is_at_traffic_light",
          "traffic_light_state",
          "actors_tracker",
      ),
      render: bool = False,
      device="cuda",
  ) -> None:
    """Collects one autopilot episode through the single-scene API, one
    npz per step (stops at the first collision)."""
    # pylint: disable=import-outside-toplevel
    from oatomobile_torch.baselines.rulebased import AutopilotAgent
    from oatomobile_torch.core.loop import EnvironmentLoop
    from oatomobile_torch.core.rl import (FiniteHorizonWrapper,
                                          SaveToDiskWrapper)
    from oatomobile_torch.envs.carla import (CARLAEnv,
                                             TerminateOnCollisionWrapper)

    os.makedirs(output_dir, exist_ok=True)
    env = CARLAEnv(
        town=town,
        sensors=sensors,
        spawn_point=spawn_point,
        destination=destination,
        num_vehicles=num_vehicles,
        num_pedestrians=num_pedestrians,
        device=device,
    )
    env = TerminateOnCollisionWrapper(env)
    env = SaveToDiskWrapper(env=env, output_dir=output_dir)
    env = FiniteHorizonWrapper(env=env, max_episode_steps=num_steps)
    EnvironmentLoop(
        agent_fn=AutopilotAgent,
        environment=env,
        render_mode="human" if render else "none",
    ).run()

  @staticmethod
  def collect_batched(
      town: str,
      output_dir: str,
      num_episodes: int = 16,
      num_steps: int = 1000,
      num_vehicles: int = 0,
      sensors: Sequence[str] = (
          "location",
          "rotation",
          "velocity",
          "acceleration",
          "lidar",
          "is_at_traffic_light",
          "traffic_light_state",
          "goal",
          "collision",
          "lane_invasion",
          "control",
      ),
      seed: int = 0,
      noise: float = 0.0,
      device="cuda",
  ) -> Sequence[str]:
    """One batched autopilot rollout of ``num_episodes`` scenes on
    ``device``, flushed to per-step npz files that :meth:`process` reads.

    Args:
      noise: expert epsilon-noise (the reference's hosted dataset used
        0.2).

    Returns the episode tokens written.
    """
    # pylint: disable=import-outside-toplevel
    from oatomobile_torch.core.dataset import tokens as token_gen
    from oatomobile_torch.envs.batched import BatchedEnv

    os.makedirs(output_dir, exist_ok=True)
    env = BatchedEnv(
        town=town,
        batch_size=num_episodes,
        sensors=sensors,
        num_vehicles=num_vehicles,
        seed=seed,
        auto_reset=False,
        device=device,
    )
    _, collected, _ = env.rollout(num_steps, policy=_noisy_autopilot(noise),
                                  collect=tuple(sensors))
    collected = {k: v.cpu().numpy() for k, v in collected.items()}

    written = []
    for n in range(num_episodes):
      episode = Episode(output_dir, next(token_gen))
      episode.append_batch({k: v[:, n] for k, v in collected.items()})
      written.append(episode.token)
    return written

  @classmethod
  def collect_packed(
      cls,
      town: str,
      output_dir: str,
      num_episodes: int = 64,
      num_steps: int = 400,
      modalities: Sequence[str] = (
          "lidar",
          "velocity",
          "acceleration",
          "is_at_traffic_light",
          "traffic_light_state",
          "goal",
      ),
      future_length: int = 80,
      past_length: int = 20,
      num_frame_skips: int = 5,
      num_vehicles: int = 0,
      noise: float = 0.0,
      seed: int = 0,
      chunk_episodes: int = 24,
      device_pack: bool = True,
      image_size: Optional[Sequence[int]] = None,
      device="cuda",
  ) -> int:
    """Batched autopilot rollouts on ``device``, windowed (past/future
    ego-frame trajectories) in memory and written straight to the packed
    format: ``collect_batched`` + ``process`` + ``pack`` fused, with no
    per-step npz files.  Scenes run ``chunk_episodes`` at a time.

    With ``device_pack`` (default) the windowing, the ego-frame transform
    and the quantisation run on the device (`_device_pack_windows`) and
    only training-ready arrays are fetched.  ``device_pack=False`` fetches
    the rollout and windows it on the host in float64 numpy.

    ``image_size``: when given (e.g. ``(100, 100)``), image modalities are
    resized on the device to this shape and quantised inside the rollout,
    step by step (the trainers' own first transform, applied at pack
    time).  Device-pack route only.

    Returns the number of training samples written.
    """
    if image_size is not None and not device_pack:
      raise ValueError("image_size requires device_pack=True")
    from oatomobile_torch.envs.batched import BatchedEnv  # pylint: disable=import-outside-toplevel

    os.makedirs(output_dir, exist_ok=True)
    sensors = tuple(sorted(set(modalities) | {"location", "rotation",
                                              "collision"}))
    buffers: dict = {key: [] for key in list(modalities) +
                     ["player_past", "player_future", "location",
                      "rotation"]}

    collect_transform = None
    if device_pack and image_size is not None:

      def collect_transform(obs):
        """Resize + uint8-quantise image modalities each step, so that the
        [T, B, ...] stack of a large chunk stays small."""
        out = dict(obs)
        for key, value in obs.items():
          if key in _QUANTIZABLE_MODALITIES and value.dim() >= 3:
            out[key] = _resize_quantize(value, image_size)
        return out

    policy = _noisy_autopilot(noise)
    done = 0
    while done < num_episodes:
      n = min(chunk_episodes, num_episodes - done)
      env = BatchedEnv(town=town, batch_size=n, sensors=sensors,
                       num_vehicles=num_vehicles, seed=seed + done,
                       auto_reset=False, device=device)
      _, collected, _ = env.rollout(num_steps, policy=policy,
                                    collect=sensors,
                                    collect_transform=collect_transform)
      done += n

      if device_pack:
        packed = _device_pack_windows(collected, modalities, past_length,
                                      future_length, num_frame_skips,
                                      image_size=image_size)
        del collected
        packed = {k: v.cpu().numpy() for k, v in packed.items()}  # fetch
        # Episode-major sample order, as the host loop's (for b: for i).
        mask = packed.pop("valid").T.reshape(-1)                 # [B*C]
        for key, value in packed.items():
          value = np.swapaxes(value, 0, 1)                       # [B, C, ...]
          flat = value.reshape((-1,) + value.shape[2:])
          buffers[key].append(flat[mask])
        continue

      collected = {k: v.cpu().numpy() for k, v in collected.items()}
      locations = collected["location"]      # [T, B, 3]
      rotations = collected["rotation"]      # [T, B, 3]
      T, B = locations.shape[:2]
      # Windows are only cut from driving before the first collision: a
      # crashed scene sits pinned against the obstacle for the rest of the
      # rollout, and those stationary frames would teach the imitation
      # models to park.
      collided = collected["collision"] > 0              # [T, B]
      crash_t = np.where(collided.any(axis=0),
                         collided.argmax(axis=0), T)     # [B]
      centers = np.arange(past_length, T - future_length, num_frame_skips)
      for b in range(B):
        loc_b = locations[:, b].astype(np.float64)
        for i in centers:
          if i + future_length >= crash_t[b]:
            continue
          past = tf_ops.np_world2local(
              current_location=loc_b[i], current_rotation=rotations[i, b],
              world_locations=loc_b[i - past_length:i])
          future = tf_ops.np_world2local(
              current_location=loc_b[i], current_rotation=rotations[i, b],
              world_locations=loc_b[i + 1:i + future_length + 1])
          buffers["player_past"].append(past.astype(np.float32))
          buffers["player_future"].append(future.astype(np.float32))
          buffers["location"].append(locations[i, b])
          buffers["rotation"].append(rotations[i, b])
          for key in modalities:
            value = np.atleast_1d(collected[key][i, b]).astype(np.float32)
            buffers[key].append(value)

    keys = sorted(buffers.keys())
    stack = np.concatenate if device_pack else np.stack
    stacked = {key: stack(buffers[key]) for key in keys}
    quantized = _save_packed_arrays(output_dir, stacked)
    num_samples = len(stacked["player_future"])
    with open(os.path.join(output_dir, "manifest.json"), "w") as fp:
      json.dump({"num_samples": num_samples, "modalities": keys,
                 "quantized": quantized}, fp)
    return num_samples

  # -- processing -----------------------------------------------------------

  @staticmethod
  def process(
      dataset_dir: str,
      output_dir: str,
      future_length: int = 80,
      past_length: int = 20,
      num_frame_skips: int = 5,
  ) -> None:
    """Converts raw episodes to imitation examples: sliding windows with
    ego-frame player_past / player_future trajectories."""
    os.makedirs(output_dir, exist_ok=True)

    for episode_token in os.listdir(dataset_dir):
      episode = Episode(parent_dir=dataset_dir, token=episode_token)
      try:
        sequence = episode.fetch()
      except FileNotFoundError:
        continue
      if len(sequence) < past_length + future_length + 1:
        continue

      # All locations loaded once: O(T) file reads, not one per window.
      observations = [episode.read_sample(tok) for tok in sequence]
      locations = np.stack([obs["location"] for obs in observations])

      for i in range(past_length, len(sequence) - future_length,
                     num_frame_skips):
        observation = observations[i]
        current_location = observation["location"]
        current_rotation = observation["rotation"]

        player_past = tf_ops.np_world2local(
            current_location=current_location,
            current_rotation=current_rotation,
            world_locations=locations[i - past_length:i])
        player_future = tf_ops.np_world2local(
            current_location=current_location,
            current_rotation=current_rotation,
            world_locations=locations[i + 1:i + future_length + 1])

        np.savez_compressed(
            os.path.join(output_dir, "{}.npz".format(sequence[i])),
            **observation,
            player_future=player_future.astype(np.float32),
            player_past=player_past.astype(np.float32))

  # -- visualisation -----------------------------------------------------------

  @staticmethod
  def plot_datum(fname: str, output_dir: str) -> None:
    """Visualises a datum (matplotlib, imported here)."""
    import matplotlib  # pylint: disable=import-outside-toplevel
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt  # pylint: disable=import-outside-toplevel

    COLORS = ["#0071bc", "#d85218", "#ecb01f", "#7d2e8d"]  # pylint: disable=invalid-name
    os.makedirs(output_dir, exist_ok=True)
    datum = np.load(fname)

    if "lidar" in datum:
      bev_meters = 25.0
      lidar = datum["lidar"]
      rgb = np.zeros(lidar.shape[:2] + (3,), dtype=np.float32)
      rgb[..., 0] = lidar[..., 0]
      rgb[..., 1] = lidar[..., 1]
      fig, ax = plt.subplots(figsize=(3.0, 3.0))
      ax.imshow(np.transpose(rgb, (1, 0, 2)),
                extent=(-bev_meters, bev_meters, bev_meters, -bev_meters))
      ax.set(frame_on=False)
      ax.get_xaxis().set_visible(False)
      ax.get_yaxis().set_visible(False)
      fig.savefig(os.path.join(output_dir, "lidar.png"),
                  bbox_inches="tight", pad_inches=0, transparent=True)
      plt.close(fig)

    for key in ("bird_view_camera_rgb", "bird_view_camera_cityscapes",
                "front_camera_rgb"):
      if key not in datum:
        continue
      fig, ax = plt.subplots(figsize=(3.0, 3.0))
      ax.imshow(datum[key])
      for traj_key, color in (("player_past", COLORS[0]),
                              ("player_future", COLORS[1])):
        if traj_key in datum:
          traj = datum[traj_key]
          ax.plot(traj[..., 1], -traj[..., 0], marker="o", markersize=3,
                  color=color, alpha=0.3)
      ax.set(frame_on=False)
      ax.get_xaxis().set_visible(False)
      ax.get_yaxis().set_visible(False)
      fig.savefig(os.path.join(output_dir, "{}.png".format(key)),
                  bbox_inches="tight", pad_inches=0, transparent=True)
      plt.close(fig)

  @classmethod
  def plot_coverage(cls, dataset_dir: str, output_fname: str,
                    color: int = 0) -> None:
    """Scatter of all trajectory locations (matplotlib, imported here)."""
    import matplotlib  # pylint: disable=import-outside-toplevel
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt  # pylint: disable=import-outside-toplevel

    COLORS = ["#0071bc", "#d85218", "#ecb01f", "#7d2e8d", "#76ab2f"]  # pylint: disable=invalid-name
    data_files = glob.glob(os.path.join(dataset_dir, "**", "*.npz"),
                           recursive=True)
    locations = []
    for npz_fname in data_files:
      try:
        locations.append(
            cls.load_datum(npz_fname, modalities=["location"],
                           mode=False)["location"])
      except Exception as e:  # pylint: disable=broad-except
        if isinstance(e, KeyboardInterrupt):
          sys.exit(0)
    locations = np.asarray(locations)
    fig, ax = plt.subplots(figsize=(3.0, 3.0))
    ax.scatter(locations[..., 0], locations[..., 1], s=5, alpha=0.1,
               color=COLORS[color % len(COLORS)])
    ax.set(title=dataset_dir, frame_on=False)
    ax.get_xaxis().set_visible(False)
    ax.get_yaxis().set_visible(False)
    fig.savefig(output_fname, bbox_inches="tight", pad_inches=0,
                transparent=True)
    plt.close(fig)

  # -- packed format -----------------------------------------------------------

  @classmethod
  def pack(
      cls,
      dataset_dir: str,
      output_dir: str,
      modalities: Sequence[str],
      mode: bool = False,
  ) -> int:
    """Packs per-sample npz files into stacked .npy arrays (one per
    modality) + a manifest: memory-mapped reads, one fancy-index a batch.

    Returns the number of samples packed.
    """
    os.makedirs(output_dir, exist_ok=True)
    filenames = sorted(glob.glob(os.path.join(dataset_dir, "*.npz")))
    if not filenames:
      raise FileNotFoundError("No .npz files in {}".format(dataset_dir))
    keys = list(modalities) + (["mode"] if mode else [])
    buffers = {key: [] for key in keys}
    for fname in filenames:
      sample = cls.load_datum(fname, modalities, mode, dataformat="HWC")
      for key in keys:
        buffers[key].append(sample[key])
    stacked = {key: np.stack(buffers[key]) for key in keys}
    quantized = _save_packed_arrays(output_dir, stacked)
    manifest = {"num_samples": len(filenames), "modalities": keys,
                "quantized": quantized}
    with open(os.path.join(output_dir, "manifest.json"), "w") as fp:
      json.dump(manifest, fp)
    return len(filenames)

  @classmethod
  def as_numpy_packed(
      cls,
      packed_dir: str,
      batch_size: int,
      shuffle: bool = True,
      seed: int = 0,
      drop_remainder: bool = True,
      dequantize: bool = False,
      split: Optional[str] = None,
      val_fraction: float = 0.05,
      split_seed: int = 1234,
      mode: bool = False,
      signed_mode: bool = True,
  ) -> Generator[Mapping[str, np.ndarray], None, None]:
    """Yields numpy batches from a packed dataset via memory-mapped reads.

    ``mode``: derive the {FORWARD, STOP, LEFT, RIGHT} command label from
    ``player_future`` per batch (signed rule by default, see
    `derive_mode_labels`).

    Quantised (uint8) image modalities are yielded as uint8 by default;
    consumers divide by 255 on the device.  ``dequantize=True`` gives
    float batches.

    ``split``: ``"train"``/``"val"`` carve a deterministic held-out
    validation set from the pack (the last ``val_fraction`` of a fixed
    ``split_seed`` permutation).
    """
    with open(os.path.join(packed_dir, "manifest.json")) as fp:
      manifest = json.load(fp)
    quantized = set(manifest.get("quantized", []))
    arrays = {
        key: np.load(os.path.join(packed_dir, "{}.npy".format(key)),
                     mmap_mode="r")
        for key in manifest["modalities"]
    }
    n = manifest["num_samples"]
    indices = cls.packed_split_indices(n, split, val_fraction=val_fraction,
                                       split_seed=split_seed)
    n = len(indices)
    order = indices
    if shuffle:
      order = order.copy()
      np.random.RandomState(seed).shuffle(order)
    stop = n - (n % batch_size) if drop_remainder else n
    for start in range(0, stop, batch_size):
      idx = np.sort(order[start:start + batch_size])
      batch = {}
      for key, arr in arrays.items():
        value = np.asarray(arr[idx])
        if key in quantized and dequantize:
          value = value.astype(np.float32) / 255.0
        batch[key] = value
      if mode and "player_future" in batch:
        batch["mode"] = derive_mode_labels(batch["player_future"],
                                           signed=signed_mode)
      yield batch

  @staticmethod
  def packed_split_indices(n: int, split: Optional[str],
                           val_fraction: float = 0.05,
                           split_seed: int = 1234) -> np.ndarray:
    """Deterministic train/val index split of a packed dataset: the last
    ``val_fraction`` of a fixed-``split_seed`` permutation is val.  Every
    loader (streaming, device-resident) derives its indices here, so the
    splits always agree."""
    if split is None:
      return np.arange(n)
    perm = np.random.RandomState(split_seed).permutation(n)
    num_val = max(1, int(round(n * val_fraction)))
    return (np.sort(perm[:-num_val]) if split == "train"
            else np.sort(perm[-num_val:]))

  @staticmethod
  def restart_transition_indices(packed_dir: str,
                                 speed_thresh: float = 1.0,
                                 move_thresh: float = 2.0) -> np.ndarray:
    """Indices of stopped->restart samples in a packed dataset: ego speed
    below ``speed_thresh`` m/s while the expert's future leaves a
    ``move_thresh``-metre disc (ego frame, so |future[-1]| is the
    displacement over the plan horizon).

    The trainers tile these indices ``oversample_restarts`` extra times
    into each epoch's order: learned agents stall in closed loop when the
    restart behaviour is a sliver of the data.  Reads only the two small
    modalities via mmap.
    """
    vel = np.load(os.path.join(packed_dir, "velocity.npy"), mmap_mode="r")
    fut = np.load(os.path.join(packed_dir, "player_future.npy"),
                  mmap_mode="r")
    speed = np.linalg.norm(np.asarray(vel[:, :2], dtype=np.float32),
                           axis=-1)
    disp = np.linalg.norm(np.asarray(fut[:, -1, :2], dtype=np.float32),
                          axis=-1)
    return np.where((speed < speed_thresh) & (disp > move_thresh))[0]

  @classmethod
  def load_packed_to_device(cls, packed_dir: str,
                            modalities: Optional[Sequence[str]] = None,
                            device="cuda"):
    """Uploads a packed dataset to ``device`` once (uint8 images stay
    uint8; consumers dequantise on the device), so that batch assembly is
    a device gather (`iter_device_batches`) with no steady-state host
    traffic.  Each array is one pinned host copy and one upload.

    Returns (dict of tensors [N, ...], num_samples).
    """
    device = device_lib.resolve(device)
    with open(os.path.join(packed_dir, "manifest.json")) as fp:
      manifest = json.load(fp)
    keys = manifest["modalities"]
    if modalities is not None:
      keep = set(modalities)
      keys = [k for k in keys if k in keep]

    def put(path):
      host = torch.from_numpy(np.load(path))
      if device.type != "cuda":
        return host.to(device)
      return host.pin_memory().to(device, non_blocking=True)

    data = {key: put(os.path.join(packed_dir, "{}.npy".format(key)))
            for key in keys}
    if device.type == "cuda":
      torch.cuda.synchronize(device)  # the pinned buffers may then go
    return data, manifest["num_samples"]

  @classmethod
  def iter_device_batches(cls, data, indices: np.ndarray, batch_size: int,
                          *, shuffle: bool = True, seed: int = 0,
                          drop_remainder: bool = True):
    """Yields batches gathered on the device from resident tensors
    (`load_packed_to_device`): the epoch's sorted batch indices go up as
    one index tensor, and each batch is an ``index_select`` of it."""
    order = np.asarray(indices)
    if shuffle:
      order = order.copy()
      np.random.RandomState(seed).shuffle(order)
    n = len(order)
    stop = n - (n % batch_size) if drop_remainder else n
    if stop == 0:
      return
    starts = range(0, stop, batch_size)
    device = next(iter(data.values())).device
    index = torch.as_tensor(np.concatenate(
        [np.sort(order[s:s + batch_size]) for s in starts]), device=device)
    for start in starts:
      idx = index[start:start + batch_size]
      yield {k: v.index_select(0, idx) for k, v in data.items()}

  @staticmethod
  def is_packed(path: str) -> bool:
    return os.path.exists(os.path.join(path, "manifest.json"))

  @staticmethod
  def merge_packed(packed_dirs: Sequence[str], output_dir: str) -> int:
    """Concatenates several packed datasets into one (e.g. collection runs
    with different traffic densities or seeds).  Modalities must match; a
    modality is stored quantised iff it is quantised in every input.
    Returns the merged sample count."""
    os.makedirs(output_dir, exist_ok=True)
    manifests = []
    for d in packed_dirs:
      with open(os.path.join(d, "manifest.json")) as fp:
        manifests.append(json.load(fp))
    keys = manifests[0]["modalities"]
    for m in manifests[1:]:
      if m["modalities"] != keys:
        raise ValueError("Modalities differ across packs: {} vs {}".format(
            keys, m["modalities"]))
    quantized = set(manifests[0].get("quantized", []))
    for m in manifests[1:]:
      quantized &= set(m.get("quantized", []))
    total = 0
    for key in keys:
      parts = []
      for d, m in zip(packed_dirs, manifests):
        arr = np.load(os.path.join(d, "{}.npy".format(key)),
                      mmap_mode="r")
        if key in set(m.get("quantized", [])) and key not in quantized:
          arr = np.asarray(arr).astype(np.float32) / 255.0
        parts.append(arr)
      merged = np.concatenate([np.asarray(p) for p in parts], axis=0)
      np.save(os.path.join(output_dir, "{}.npy".format(key)), merged)
      total = len(merged)
    with open(os.path.join(output_dir, "manifest.json"), "w") as fp:
      json.dump({"num_samples": total, "modalities": keys,
                 "quantized": sorted(quantized)}, fp)
    return total

  @classmethod
  def make_loader(cls, dataset_dir: str, modalities: Sequence[str],
                  batch_size: int, mode: bool = False, seed: int = 0,
                  prefetch: int = 0, split: Optional[str] = None,
                  val_fraction: float = 0.05):
    """Batch loader that detects the packed format.

    ``prefetch`` runs the loader in a background thread (off by default:
    on a single-core host the GIL makes it slower).

    ``split``: "train"/"val" for a deterministic held-out validation
    subset (packed format only; per-file datasets load everything)."""
    if cls.is_packed(dataset_dir):
      it = cls.as_numpy_packed(
          dataset_dir, batch_size=batch_size, seed=seed, split=split,
          mode=mode,
          val_fraction=val_fraction,
          shuffle=(split != "val"),
          drop_remainder=(split != "val"))
    else:
      it = cls.as_numpy_batched(dataset_dir, modalities,
                                batch_size=batch_size, mode=mode, seed=seed)
    if prefetch <= 0:
      return it
    return _prefetch_iterator(it, prefetch)

  # -- framework adapters -----------------------------------------------------

  @classmethod
  def as_numpy_batched(
      cls,
      dataset_dir: str,
      modalities: Sequence[str],
      batch_size: int,
      mode: bool = False,
      shuffle: bool = True,
      seed: int = 0,
      drop_remainder: bool = True,
  ) -> Generator[Mapping[str, np.ndarray], None, None]:
    """Yields stacked numpy batches (NHWC images) of per-sample npz files."""
    filenames = sorted(glob.glob(os.path.join(dataset_dir, "*.npz")))
    if not filenames:
      raise FileNotFoundError("No .npz files in {}".format(dataset_dir))
    rng = np.random.RandomState(seed)
    order = np.arange(len(filenames))
    if shuffle:
      rng.shuffle(order)
    batch = []
    for idx in order:
      sample = cls.load_datum(filenames[idx], modalities, mode,
                              dataformat="HWC")
      sample.pop("name", None)
      batch.append(sample)
      if len(batch) == batch_size:
        yield {
            key: np.stack([s[key] for s in batch])
            for key in batch[0]
        }
        batch = []
    if batch and not drop_remainder:
      yield {key: np.stack([s[key] for s in batch]) for key in batch[0]}

  @classmethod
  def as_numpy(
      cls,
      dataset_dir: str,
      modalities: Sequence[str],
      mode: bool = False,
  ) -> Generator[Mapping[str, np.ndarray], None, None]:
    """Unbatched numpy sample generator."""
    filenames = sorted(glob.glob(os.path.join(dataset_dir, "*.npz")))
    for npz_fname in filenames:
      yield cls.load_datum(npz_fname, modalities, mode, dataformat="HWC")

  @classmethod
  def as_torch(
      cls,
      dataset_dir: str,
      modalities: Sequence[str],
      transform: Optional[Callable[[Any], Any]] = None,
      mode: bool = False,
      only_array: bool = False,
  ) -> torch.utils.data.Dataset:
    """A ``torch.utils.data.Dataset`` of the per-sample npz files (CHW
    images)."""
    del only_array  # the reference's argument; arrays are all it keeps

    class PyTorchDataset(torch.utils.data.Dataset):
      """Data reader for the expert demonstrations."""

      def __init__(self):
        self._npz_files = sorted(
            glob.glob(os.path.join(dataset_dir, "*.npz")))

      def __len__(self):
        return len(self._npz_files)

      def __getitem__(self, idx):
        sample = cls.load_datum(fname=self._npz_files[idx],
                                modalities=modalities, mode=mode,
                                dataformat="CHW")
        for key in list(sample):
          if not isinstance(sample[key], np.ndarray):
            sample.pop(key)
        if transform is not None:
          sample = {key: transform(val) for key, val in sample.items()}
        return sample

    return PyTorchDataset()

  @classmethod
  def as_tensorflow(cls, dataset_dir: str, modalities: Sequence[str],
                    mode: bool = False):
    """TensorFlow dataset adapter; raises ImportError without tensorflow
    (imported here, never by the package)."""
    import tensorflow as tf  # pylint: disable=import-outside-toplevel

    filenames = sorted(glob.glob(os.path.join(dataset_dir, "*.npz")))
    output_shapes = {}
    with np.load(filenames[0]) as datum:
      for modality in modalities:
        output_shapes[modality] = tf.TensorShape(
            np.atleast_1d(datum[modality]).shape)
    if mode:
      output_shapes["mode"] = tf.TensorShape((1,))
    output_types = {m: tf.float32 for m in output_shapes}

    return tf.data.Dataset.from_generator(
        generator=lambda: (
            {k: v for k, v in cls.load_datum(f, modalities, mode,
                                             "HWC").items()
             if k != "name"} for f in filenames),
        output_types=output_types,
        output_shapes=output_shapes,
    )
