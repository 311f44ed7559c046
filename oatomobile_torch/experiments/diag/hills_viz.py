"""Draw the CARNOVEL Hills crash scenes: for each collision episode the
road mask around the crash point with the hero's box, the nearest NPCs'
boxes and headings, and the hero's route, to see what the hero hits on
the switchbacks.  Port of the JAX package's ``scripts/diag_hills_viz.py``.

    python -m oatomobile_torch.experiments.diag.hills_viz [--cpu]
        [--episodes 10] [--horizon 1500] [--family Hills] [--out DIR]
        [--max-plots 12]

The rollout and the snapshots of the state before each first collision
are the device's work (:func:`run`); the drawing is matplotlib on the
host (:func:`draw`), which ``main`` needs.
"""

import os

import numpy as np

from oatomobile_torch.experiments.diag import common, hills
from oatomobile_torch.maps import load_town


def snapshot(params, state) -> dict:
  """The state's fields the drawing reads."""
  del params
  return {"hero_xy": state.hero_xy, "hero_yaw": state.hero_yaw,
          "npc_xy": state.npc_xy, "npc_yaw": state.npc_yaw,
          "npc_alive": state.npc_alive, "npc_speed": state.npc_speed,
          "route_pos": state.route_pos, "hero_speed": state.hero_speed}


def run(episodes: int = 10, horizon: int = 1500, family: str = "Hills",
        device="cuda") -> dict:
  """The rollout (seed 7): ``m`` (numpy, the snapshots under ``crash``),
  the final routes and the task ``ids``."""
  ids, town, params, states = hills.family_scenes(family, episodes, device)
  m, final = common.run(
      params, states, common.autopilot,
      hills.make_accumulate(params, snapshot),
      hills.initial(params, states, snapshot), horizon, device)
  return {"town": town, "ids": ids, "episodes": episodes,
          "m": common.host(m), "route": final.route.numpy(),
          "route_len": final.route_len.numpy(),
          "vehicle": (float(params.vehicle.length),
                      float(params.vehicle.width))}


def draw(r: dict, out: str, max_plots: int = 12) -> list:
  """The first ``max_plots`` crash scenes as PNGs under ``out``
  (matplotlib); returns their paths."""
  # pylint: disable=import-outside-toplevel
  import matplotlib
  matplotlib.use("Agg")
  import matplotlib.pyplot as plt
  from matplotlib.patches import Rectangle
  from matplotlib.transforms import Affine2D

  town = load_town(r["town"])
  crash, (L, W) = r["m"]["crash"], r["vehicle"]
  T = len(r["ids"])

  def draw_box(ax, xy, yaw, color, alpha=0.9):
    tr = Affine2D().rotate(yaw).translate(*xy) + ax.transData
    ax.add_patch(Rectangle((-L / 2, -W / 2), L, W, facecolor=color,
                           edgecolor="k", lw=0.5, alpha=alpha, transform=tr))
    ax.arrow(xy[0], xy[1], 2.5 * np.cos(yaw), 2.5 * np.sin(yaw),
             head_width=0.6, color="k", lw=0.5)

  written = []
  for i in np.where(r["m"]["collided"])[0][:max_plots]:
    hx, hy = crash["hero_xy"][i]
    fig, ax = plt.subplots(figsize=(7, 7))
    ext = (town.raster_origin[0],
           town.raster_origin[0] + town.road_mask.shape[0] / town.raster_ppm,
           town.raster_origin[1],
           town.raster_origin[1] + town.road_mask.shape[1] / town.raster_ppm)
    ax.imshow(town.road_mask.T, origin="lower", cmap="gray", extent=ext)
    pts = town.wp_xy[r["route"][i][:r["route_len"][i]]]
    ax.plot(pts[:, 0], pts[:, 1], "c-", lw=1.0, alpha=0.6)
    rp = int(crash["route_pos"][i])
    ax.plot(pts[max(rp - 5, 0):rp + 8, 0], pts[max(rp - 5, 0):rp + 8, 1],
            "c.-", lw=2.0)
    draw_box(ax, (hx, hy), crash["hero_yaw"][i], "tab:red")
    d = np.linalg.norm(crash["npc_xy"][i] - np.array([hx, hy]), axis=-1)
    for j in np.argsort(d)[:8]:
      if not crash["npc_alive"][i][j] or d[j] > 30:
        continue
      draw_box(ax, crash["npc_xy"][i][j], crash["npc_yaw"][i][j],
               "tab:blue", alpha=0.7)
      ax.annotate("{:.1f}".format(crash["npc_speed"][i][j]),
                  crash["npc_xy"][i][j], fontsize=7)
    ax.set_xlim(hx - 25, hx + 25)
    ax.set_ylim(hy - 25, hy + 25)
    task = r["ids"][i % T]
    ax.set_title("{} ep{} hero_v={:.1f}".format(task, i // T,
                                                crash["hero_speed"][i]))
    fn = os.path.join(out, "crash_{}_{}.png".format(task, i))
    fig.savefig(fn, dpi=110)
    plt.close(fig)
    written.append(fn)
  return written


def main(argv=None) -> None:
  from oatomobile_torch.experiments import pipeline  # pylint: disable=import-outside-toplevel
  ap = common.parser(__doc__.splitlines()[0])
  ap.add_argument("--episodes", type=int, default=10)
  ap.add_argument("--horizon", type=int, default=1500)
  ap.add_argument("--family", default="Hills")
  ap.add_argument("--out", default=pipeline.default_out("hills_viz"))
  ap.add_argument("--max-plots", type=int, default=12)
  args = ap.parse_args(argv)
  common.require_matplotlib("hills_viz")
  r = run(args.episodes, args.horizon, args.family, common.device_of(args))
  os.makedirs(args.out, exist_ok=True)
  for fn in draw(r, args.out, args.max_plots):
    print("wrote", fn)


if __name__ == "__main__":
  main()
