"""Host-side rendering utilities: a copy of the JAX package's
``utils/graphics.py`` (plain numpy; matplotlib and PIL are imported inside
the functions that need them, never at import time).

What stays on the host of the reference's pygame graphics: LIDAR to RGB,
image downsampling, binary masks, and dashboards for humans (a matplotlib
figure, a numpy compositor for per-step frames, a live window).
"""

from typing import Mapping, Optional, Sequence

import numpy as np


def lidar_2darray_to_rgb(array: np.ndarray) -> np.ndarray:
  """Returns a [H, W, 3] RGB visualisation of a 2-channel BEV LIDAR splat
  (the reference's lidar_2darray_to_rgb: channels into colours)."""
  array = np.asarray(array)
  h, w = array.shape[:2]
  rgb = np.zeros((h, w, 3), dtype=np.float32)
  rgb[..., 0] = array[..., 0]          # below (ground) -> red
  rgb[..., 1] = array[..., 1]          # above (obstacles) -> green
  rgb[..., 2] = 0.2 * (array[..., 0] + array[..., 1])
  return np.clip(rgb, 0.0, 1.0)


def downsample(image: np.ndarray, factor: int = 1) -> np.ndarray:
  """Strided spatial downsampling."""
  if factor <= 1:
    return image
  return image[::factor, ::factor]


def rgb_to_binary_mask(image: np.ndarray,
                       threshold: float = 0.1) -> np.ndarray:
  """Any-channel-active binary mask from an RGB image."""
  image = np.asarray(image, dtype=np.float32)
  if image.max() > 1.5:
    image = image / 255.0
  return (image.max(axis=-1) > threshold).astype(np.int32)


def make_dashboard(observations: Mapping[str, np.ndarray],
                   output_fname: Optional[str] = None,
                   keys: Sequence[str] = ("bird_view_camera_rgb",
                                          "front_camera_rgb", "lidar")):
  """Composes the available visual observations into one dashboard image
  (the human-facing role of the reference's make_dashboard).

  Returns the matplotlib figure; saves a PNG when ``output_fname`` is
  given.
  """
  import matplotlib  # pylint: disable=import-outside-toplevel
  matplotlib.use("Agg")
  import matplotlib.pyplot as plt  # pylint: disable=import-outside-toplevel

  panels = []
  for key in keys:
    if key not in observations:
      continue
    value = np.asarray(observations[key])
    if key == "lidar":
      value = lidar_2darray_to_rgb(value)
    panels.append((key, value))
  if not panels:
    raise ValueError("No visual observations among {}".format(list(keys)))

  fig, axs = plt.subplots(1, len(panels), figsize=(4 * len(panels), 4))
  if len(panels) == 1:
    axs = [axs]
  for ax, (key, value) in zip(axs, panels):
    ax.imshow(np.clip(value, 0.0, 1.0))
    ax.set_title(key)
    ax.axis("off")
  if output_fname is not None:
    fig.savefig(output_fname, bbox_inches="tight", pad_inches=0.1)
  return fig


def _to_uint8(img: np.ndarray) -> np.ndarray:
  img = np.asarray(img)
  if img.dtype != np.uint8:
    img = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
  return img


def _resize_nearest(img: np.ndarray, h: int, w: int) -> np.ndarray:
  """Nearest-neighbour resize without external dependencies."""
  ys = (np.arange(h) * img.shape[0] / h).astype(np.int32)
  xs = (np.arange(w) * img.shape[1] / w).astype(np.int32)
  return img[ys][:, xs]


def compose_dashboard_frame(
    panels: Mapping[str, np.ndarray],
    hud: Optional[Mapping[str, object]] = None,
    panel_size: int = 240,
) -> np.ndarray:
  """Composes sensor panels and a state HUD into one uint8 frame.

  The reference's live multi-sensor display (camera views side by side in
  a pygame window) as a pure-numpy compositor, cheap enough to run every
  step for MonitorWrapper GIFs.

  Args:
    panels: name -> image ([H, W, 3] RGB float/uint8, or [H, W, 2]
      LIDAR splats, which are colourised).
    hud: optional scalars (speed_mps, step, collided, throttle, steer,
      brake) drawn as a readout strip under the panels.
    panel_size: each panel is letterboxed into a panel_size^2 tile.

  Returns a [panel_size (+hud), N * panel_size, 3] uint8 image.
  """
  tiles = []
  for img in panels.values():
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[-1] == 2:
      img = lidar_2darray_to_rgb(img)
    img = _to_uint8(img)
    if img.ndim == 2:
      img = np.stack([img] * 3, axis=-1)
    # Letterbox into a square tile, preserving aspect.
    h, w = img.shape[:2]
    scale = min(panel_size / h, panel_size / w)
    nh, nw = max(1, int(h * scale)), max(1, int(w * scale))
    resized = _resize_nearest(img, nh, nw)
    tile = np.zeros((panel_size, panel_size, 3), dtype=np.uint8)
    y0 = (panel_size - nh) // 2
    x0 = (panel_size - nw) // 2
    tile[y0:y0 + nh, x0:x0 + nw] = resized
    tiles.append(tile)
  if not tiles:
    raise ValueError("No panels to compose")
  frame = np.concatenate(tiles, axis=1)

  if hud is not None:
    frame = np.concatenate([frame, _hud_strip(hud, frame.shape[1])], axis=0)
  return frame


def _hud_strip(hud: Mapping[str, object], width: int,
               height: int = 36) -> np.ndarray:
  """Text and bar readout strip (PIL text; bars for the control
  channels; bars only without PIL)."""
  strip = np.full((height, width, 3), 24, dtype=np.uint8)

  # Control bars: throttle (green), brake (red), steer (blue, centred).
  def bar(row, frac, color, lo=0.0, hi=1.0):
    frac = float(np.clip((frac - lo) / (hi - lo), 0.0, 1.0))
    x1 = int(8 + frac * (width // 3 - 16))
    strip[row:row + 6, 8:max(x1, 9)] = color

  if "throttle" in hud:
    bar(6, hud["throttle"], (80, 200, 80))
  if "brake" in hud:
    bar(16, hud["brake"], (220, 80, 80))
  if "steer" in hud:
    bar(26, hud["steer"], (90, 140, 240), lo=-1.0, hi=1.0)

  text_parts = []
  if "speed_mps" in hud:
    text_parts.append("{:4.1f} km/h".format(3.6 * float(hud["speed_mps"])))
  if "step" in hud:
    text_parts.append("t={}".format(int(hud["step"])))
  if hud.get("collided"):
    text_parts.append("COLLISION")
  if text_parts:
    try:
      from PIL import Image, ImageDraw  # pylint: disable=import-outside-toplevel
      img = Image.fromarray(strip)
      draw = ImageDraw.Draw(img)
      draw.text((width // 3 + 12, 10), "   ".join(text_parts),
                fill=(230, 230, 230))
      if hud.get("collided"):
        draw.rectangle([width - 14, 6, width - 6, height - 6],
                       fill=(255, 40, 40))
      strip = np.asarray(img)
    except ImportError:
      pass  # bars-only HUD
  return strip


def plot_trajectory_overlay(bev: np.ndarray,
                            trajectories: Mapping[str, np.ndarray],
                            meters: float = 25.0,
                            output_fname: Optional[str] = None):
  """Overlays ego-frame trajectories on a BEV image ([H, W, 3], or a
  [H, W, 2] LIDAR splat)."""
  import matplotlib  # pylint: disable=import-outside-toplevel
  matplotlib.use("Agg")
  import matplotlib.pyplot as plt  # pylint: disable=import-outside-toplevel

  bev = np.asarray(bev)
  if bev.ndim == 3 and bev.shape[-1] == 2:
    bev = lidar_2darray_to_rgb(bev)
  fig, ax = plt.subplots(figsize=(4, 4))
  ax.imshow(np.transpose(bev, (1, 0, 2)),
            extent=(-meters, meters, meters, -meters))
  colors = ["#0071bc", "#d85218", "#ecb01f", "#7d2e8d", "#76ab2f"]
  for i, (label, traj) in enumerate(trajectories.items()):
    traj = np.asarray(traj)
    ax.plot(traj[..., 1], -traj[..., 0], marker="o", markersize=3,
            color=colors[i % len(colors)], alpha=0.6, label=label)
  ax.legend(loc="upper right", fontsize=7)
  ax.set(frame_on=False)
  ax.get_xaxis().set_visible(False)
  ax.get_yaxis().set_visible(False)
  if output_fname is not None:
    fig.savefig(output_fname, bbox_inches="tight", pad_inches=0,
                transparent=True)
  return fig


class LiveViewer:
  """Live dashboard window, the role of the reference's pygame display:
  a matplotlib interactive figure refreshed in place (imshow set_data).
  On a headless host (the Agg backend, or no GUI), frames are dropped
  with a single warning instead of raising, so ``--live`` is safe to pass
  anywhere.
  """

  def __init__(self, refresh_hz: float = 5.0, title: str = "oatomobile"):
    self._min_dt = 1.0 / max(refresh_hz, 1e-3)
    self._title = title
    self._last = 0.0
    self._fig = None
    self._image = None
    self._dead = False

  def show(self, frame: np.ndarray) -> None:
    """Displays ``frame`` (uint8 [H, W, 3]), rate-limited to refresh_hz."""
    import time  # pylint: disable=import-outside-toplevel
    if self._dead or frame is None:
      return
    now = time.time()
    if now - self._last < self._min_dt:
      return
    self._last = now
    try:
      import matplotlib  # pylint: disable=import-outside-toplevel
      import matplotlib.pyplot as plt  # pylint: disable=import-outside-toplevel
      if self._fig is None:
        if matplotlib.get_backend().lower() == "agg":
          raise RuntimeError("headless (Agg) backend")
        plt.ion()
        self._fig, ax = plt.subplots(num=self._title)
        ax.set_axis_off()
        self._image = ax.imshow(frame)
      else:
        self._image.set_data(frame)
      self._fig.canvas.draw_idle()
      self._fig.canvas.flush_events()
    except Exception as exc:  # pylint: disable=broad-except
      # Headless host, or the window was closed.
      if not self._dead:
        import logging  # pylint: disable=import-outside-toplevel
        logging.getLogger(__name__).warning("live view disabled: %s", exc)
      self._dead = True

  def close(self) -> None:
    if self._fig is not None:
      import matplotlib.pyplot as plt  # pylint: disable=import-outside-toplevel
      plt.close(self._fig)
      self._fig = None
