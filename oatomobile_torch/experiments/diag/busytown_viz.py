"""Draw where BusyTown timeout episodes end: the hero, its route, its
sampled path and every NPC within 40 m at the final step, with a summary
of the hero's speed trace, to localise the grind spot.  Port of the JAX
package's ``scripts/diag_busytown_viz.py``.

    python -m oatomobile_torch.experiments.diag.busytown_viz [--cpu]
        [--episodes 5] [--horizon 1500]
        [--tasks BusyTown7-v0,BusyTown9-v0] [--out DIR]

The rollout and its traces are the device's work (:func:`run`); the
drawing is matplotlib on the host (:func:`draw`), which ``main`` needs.
"""

import os

import numpy as np
import torch

from oatomobile_torch.experiments.diag import common
from oatomobile_torch.maps import load_town

# The hero's position is sampled every SAMPLE steps for the path.
SAMPLE = 30
# The final state's fields the drawing reads.
FINAL_FIELDS = ("hero_xy", "hero_yaw", "hero_speed", "npc_xy", "npc_yaw",
                "npc_alive", "npc_speed", "route", "route_len")


def initial(states, horizon: int) -> dict:
  B, device = states.batch_size, states.hero_xy.device
  samples = len(range(0, horizon, SAMPLE))
  return {"collided": torch.zeros(B, dtype=torch.bool, device=device),
          "success": torch.zeros(B, dtype=torch.bool, device=device),
          "active": torch.ones(B, dtype=torch.bool, device=device),
          "t": torch.zeros(1, dtype=torch.int32, device=device),
          "trace_v": torch.zeros((horizon, B), device=device),
          "trace_xy": torch.zeros((samples, B, 2), device=device)}


def accumulate(m, old_state, new, active):
  """The outcome flags, and the step's hero speed and (every SAMPLE
  steps) position written at the step counter ``t``."""
  del old_state
  collided = (new.collision > 0.0) & active
  arrived = common.arrived(new) & active
  t = m["t"]
  slot = torch.div(t, SAMPLE, rounding_mode="floor").long()
  xy = torch.where((t % SAMPLE == 0)[:, None, None], new.hero_xy[None],
                   m["trace_xy"].index_select(0, slot))
  return {"collided": m["collided"] | collided,
          "success": m["success"] | arrived,
          "active": active & ~collided & ~arrived,
          "t": t + 1,
          "trace_v": m["trace_v"].index_copy(0, t.long(),
                                             new.hero_speed[None]),
          "trace_xy": m["trace_xy"].index_copy(0, slot, xy)}


def run(tasks=("BusyTown7-v0", "BusyTown9-v0"), episodes: int = 5,
        horizon: int = 1500, device="cuda") -> dict:
  """The rollout (seed 7): ``m`` (numpy; the hero's speed every step in
  ``trace_v`` [H, B], its position every SAMPLE steps in ``trace_xy``),
  the final state's ``final`` fields and the task ``ids``."""
  ids = list(tasks)
  town, params, states = common.carnovel_scenes(ids, episodes, 7, device)
  m, final = common.run(params, states, common.autopilot, accumulate,
                        initial(states, horizon), horizon, device)
  return {"town": town, "ids": ids, "episodes": episodes, "m": common.host(m),
          "final": {k: getattr(final, k).numpy() for k in FINAL_FIELDS},
          "vehicle": (float(params.vehicle.length),
                      float(params.vehicle.width))}


def episodes(r: dict):
  """(scene, task id, episode, tag, summary line) of each scene."""
  m, ids = r["m"], r["ids"]
  T = len(ids)
  for i in range(len(m["success"])):
    tag = ("succ" if m["success"][i] else
           "coll" if m["collided"][i] else "timeout")
    v = m["trace_v"][:, i]
    line = ("{} ep{}: {:8s} mean_v {:4.2f} frac<1 {:5.1%} frac 1-3 "
            "{:5.1%}".format(ids[i % T], i // T, tag, v.mean(),
                             np.mean(v < 1.0),
                             np.mean((v >= 1.0) & (v < 3.0))))
    yield i, ids[i % T], i // T, tag, line


def draw(r: dict, i: int, out: str) -> str:
  """The end scene of scene ``i`` as a PNG under ``out`` (matplotlib);
  returns its path."""
  # pylint: disable=import-outside-toplevel
  import matplotlib
  matplotlib.use("Agg")
  import matplotlib.pyplot as plt
  from matplotlib.patches import Rectangle
  from matplotlib.transforms import Affine2D

  town = load_town(r["town"])
  f, (L, W) = r["final"], r["vehicle"]
  T = len(r["ids"])
  task = r["ids"][i % T]

  def draw_box(ax, xy, yaw, color, alpha=0.9):
    tr = Affine2D().rotate(yaw).translate(*xy) + ax.transData
    ax.add_patch(Rectangle((-L / 2, -W / 2), L, W, facecolor=color,
                           edgecolor="k", lw=0.5, alpha=alpha, transform=tr))
    ax.arrow(xy[0], xy[1], 2.0 * np.cos(yaw), 2.0 * np.sin(yaw),
             head_width=0.5, color="k", lw=0.5)

  hx, hy = f["hero_xy"][i]
  fig, ax = plt.subplots(figsize=(7, 7))
  ext = (town.raster_origin[0],
         town.raster_origin[0] + town.road_mask.shape[0] / town.raster_ppm,
         town.raster_origin[1],
         town.raster_origin[1] + town.road_mask.shape[1] / town.raster_ppm)
  ax.imshow(town.road_mask.T, origin="lower", cmap="gray", extent=ext)
  pts = town.wp_xy[f["route"][i][:f["route_len"][i]]]
  ax.plot(pts[:, 0], pts[:, 1], "c-", lw=1.2, alpha=0.7)
  tr = r["m"]["trace_xy"][:, i]
  ax.plot(tr[:, 0], tr[:, 1], "y.-", lw=0.8, ms=2, alpha=0.8)
  draw_box(ax, (hx, hy), float(f["hero_yaw"][i]), "tab:red")
  d = np.linalg.norm(f["npc_xy"][i] - [hx, hy], axis=-1)
  for j in np.where(f["npc_alive"][i] & (d < 40))[0]:
    draw_box(ax, f["npc_xy"][i][j], f["npc_yaw"][i][j], "tab:blue",
             alpha=0.7)
    ax.annotate("{:.1f}".format(f["npc_speed"][i][j]), f["npc_xy"][i][j],
                fontsize=6)
  ax.set_xlim(hx - 40, hx + 40)
  ax.set_ylim(hy - 40, hy + 40)
  ax.set_title("{} ep{} timeout v_end={:.1f}".format(
      task, i // T, float(f["hero_speed"][i])))
  fn = os.path.join(out, "timeout_{}_{}.png".format(task, i))
  fig.savefig(fn, dpi=110)
  plt.close(fig)
  return fn


def main(argv=None) -> None:
  from oatomobile_torch.experiments import pipeline  # pylint: disable=import-outside-toplevel
  ap = common.parser(__doc__.splitlines()[0])
  ap.add_argument("--episodes", type=int, default=5)
  ap.add_argument("--horizon", type=int, default=1500)
  ap.add_argument("--tasks", default="BusyTown7-v0,BusyTown9-v0")
  ap.add_argument("--out", default=pipeline.default_out("busytown_viz"))
  args = ap.parse_args(argv)
  common.require_matplotlib("busytown_viz")
  r = run(args.tasks.split(","), args.episodes, args.horizon,
          common.device_of(args))
  os.makedirs(args.out, exist_ok=True)
  for i, _, _, tag, line in episodes(r):
    print(line)
    if tag == "timeout":
      print("  wrote", draw(r, i, args.out))


if __name__ == "__main__":
  main()
