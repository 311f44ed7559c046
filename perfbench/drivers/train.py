"""The DIM training cell: the trainer's updates back to back on a packed
dataset resident on the card, as ``baselines/learned/dim/train.train``
runs them.

Set-up makes the dataset from the seed on the card (the trainer's packed
format: uint8 LIDAR, velocity, traffic-light fields, expert futures, with
stopped and restarting samples), writes its two small modalities into a
scratch directory under ``TMPDIR`` for the trainer's restart
oversampling, builds the train state (the benchmark's weights, the
trainer's Adam and key) and drives it through its first updates with the
window's own call and loader.  The window runs updates for ``seconds``,
with CUDA events recorded between consecutive updates (read after it) and
a fetch of the last loss at its end.  After it: with ``trace``, profiled
updates; then the check, once the program's state is freed: the
reference follows the first three updates from the same weights and raw
data.
"""

import gc
import os
import statistics
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from perfbench import check as check_lib
from perfbench import trace as trace_lib
from perfbench import weights as weights_lib
from perfbench.counts import dim_flops
from perfbench import link
from perfbench.drivers.rollout import LINK_WARM_S, env_seed, percentile
from perfbench.report import Result

CHECK_STEPS = 3
B1 = 0.9


def make_pack(n: int, size: int, seed: int, device) -> Dict[str, torch.Tensor]:
  """The packed dataset, drawn on ``device`` from ``seed`` in a few large
  calls: dense uint8 LIDAR; a fifth of the samples stopped (speed 0), half
  of those restarting (their expert future moves off at 2-8 m/s); the
  others moving at 0-8 m/s with forward futures of 80 steps."""
  gen = torch.Generator(device=device)
  gen.manual_seed(int(seed) % (2**63))

  def u(*shape):
    return torch.rand(shape, generator=gen, device=device)

  lidar = torch.randint(0, 256, (n, size, size, 2), generator=gen,
                        device=device, dtype=torch.uint8)
  speed = 8.0 * u(n, 1)
  stopped = u(n, 1) < 0.2
  restart = stopped & (u(n, 1) < 0.5)
  speed = torch.where(stopped, 0.0, speed)
  pace = torch.where(restart, 2.0 + 6.0 * u(n, 1),
                     torch.clamp_min(speed, 0.05))
  step = (0.5 + u(n, 80, 3)) * torch.tensor([0.1, 0.02, 0.0], device=device)
  future = torch.cumsum(step, dim=1) * pace[:, :, None]
  lateral = 0.3 * torch.randn((n, 1), generator=gen, device=device)
  return {
      "lidar": lidar,
      "is_at_traffic_light": torch.randint(
          0, 2, (n, 1), generator=gen, device=device).to(torch.float32),
      "traffic_light_state": torch.randint(
          0, 3, (n, 1), generator=gen, device=device).to(torch.float32),
      "velocity": torch.cat([speed, lateral, torch.zeros_like(speed)], -1),
      "player_future": future,
  }


def _weights(config, seed, device):
  from perfbench.reference.models.dim import ImitativeModel  # pylint: disable=import-outside-toplevel
  shape = ImitativeModel(tuple(config["output_shape"]),
                         tuple(config["input_size"]), device="meta")
  return weights_lib.draw(shape, seed, device)


def _event_ms(events: List[torch.cuda.Event]) -> List[float]:
  events[-1].synchronize()
  return [a.elapsed_time(b) for a, b in zip(events, events[1:])]


def run(cell, *, seed: int, seconds: float, trace: bool, control: bool,
        device, process_start: float, overrides=None) -> Result:
  """One run of the training cell (``overrides`` replaces traffic keys:
  the tests run it at a small size on the CPU)."""
  from oatomobile_torch import rng as rng_lib  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.baselines.learned.dim import train as dim_train  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.models import ImitativeModel  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.parallel import dp  # pylint: disable=import-outside-toplevel
  traffic = dict(cell["traffic"], **(overrides or {}))
  config = cell["config"]
  cuda = torch.device(device).type == "cuda"
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  n, batch = int(traffic["samples"]), int(traffic["batch"])
  loader_seed = env_seed(seed)

  # --- set-up ----------------------------------------------------------------
  pack = make_pack(n, int(traffic["image_size"]), seed, device)
  weights = _weights(config, seed, device)
  model = weights_lib.load(ImitativeModel(tuple(config["output_shape"]),
                                          tuple(config["input_size"]),
                                          device="meta"), weights, device)
  state = dp.TrainState.create(
      model, dp.adam(model, traffic["lr"]),
      rng_lib.fold_in(rng_lib.PRNGKey(loader_seed, device), 1))
  update = dp.make_update_fn(dim_train.make_loss_fn(
      traffic["velocity_dropout"]))
  with tempfile.TemporaryDirectory(prefix="perfbench-pack-") as small:
    for key in ("velocity", "player_future"):
      np.save(os.path.join(small, key + ".npy"), pack[key].cpu().numpy())
    epoch_loader, _ = dim_train.make_loaders(
        small, pack, n, batch, loader_seed, True, traffic["val_fraction"],
        traffic["oversample_restarts"])

    def batches():
      epoch = 0
      while True:
        yield from epoch_loader(epoch)
        epoch += 1

    feed = batches()
    # The first updates, through the window's own call and loader: the
    # check follows them.
    params0 = {k: v.detach().clone() for k, v in model.named_parameters()}
    losses = []
    first_grads = None
    for step in range(CHECK_STEPS):
      state, loss = update(state, next(feed))
      losses.append(loss)
      if step == 0:
        # The gradient as Adam got it: its first moment after one step
        # is (1 - b1) g (none where the optimiser did not step).
        first_grads = {
            name: (state.optimizer.state[p]["exp_avg"].detach() / (1 - B1)
                   if "exp_avg" in state.optimizer.state.get(p, {})
                   else torch.zeros_like(p))
            for name, p in model.named_parameters()}
    params3 = {k: v.detach().clone() for k, v in model.named_parameters()}
    losses = [float(x) for x in losses]
    for _ in range(int(traffic["warm_updates"])):
      state, loss = update(state, next(feed))
    float(loss)
    setup_peak = link.warm(LINK_WARM_S, device)

    # --- the window ----------------------------------------------------------
    events = []
    start = time.perf_counter()
    setup_s = start - process_start
    updates = 0
    while time.perf_counter() - start < seconds:
      ev = torch.cuda.Event(enable_timing=True) if cuda else None
      if cuda:
        ev.record()
        events.append(ev)
      state, loss = update(state, next(feed))
      updates += 1
    if cuda:
      ev = torch.cuda.Event(enable_timing=True)
      ev.record()
      events.append(ev)
    float(loss)
    window_s = time.perf_counter() - start
    peak = max(setup_peak, torch.cuda.max_memory_allocated() if cuda else 0)
    update_ms = (_event_ms(events) if cuda else
                 [1e3 * window_s / updates] * updates)

    result = Result(attempted=updates)
    result.end_to_end = {
        "train_samples_per_s": updates * batch / window_s,
        "update_ms_p95": percentile(update_ms, 95),
        "setup_s": setup_s,
    }
    result.notes = {"updates": updates, "window_s": window_s,
                    "update_ms_median": statistics.median(update_ms),
                    "losses": losses}
    result.device = {"count": 1, "memory_peak_bytes": int(peak)}

    if trace:
      traced = int(traffic["trace_updates"])

      def gathers():
        for _ in range(traced):
          with trace_lib.span("loader.gather", sync=True):
            next(feed)

      def updates_run():
        for _ in range(traced):
          update(state, next(feed))

      gather = trace_lib.profile(gathers)
      replay = trace_lib.profile(updates_run)
      result.context = {
          "update_ms": 1e3 * window_s / updates, "train": replay,
          "train_updates": traced, "gather": gather,
          "gather_batches": traced,
          "update_flops": dim_flops.training_update_flops(config, batch),
      }
      result.device.update(busy_s=replay.busy_us() / 1e6,
                           window_s=replay.seconds)
      result.breakdown = {"device_ops": replay.top_ops(),
                          "idle_gaps": replay.idle_gaps()}

  del state, model, update, feed, epoch_loader
  gc.collect()
  if cuda:
    torch.cuda.empty_cache()
  t0 = time.perf_counter()
  result.checks, result.notes["worst_leaf_change_gap"] = compare(
      config, traffic, pack, weights, loader_seed, losses, first_grads,
      params0, params3, control, device)
  result.notes["check_s"] = time.perf_counter() - t0
  return result


def _leaf_norm_gaps(got: Dict[str, torch.Tensor],
                    want: Dict[str, torch.Tensor], names) -> List[float]:
  """Each leaf's gap of norms: | |got| - |want| | over the larger of
  |want| and the median leaf's |want|."""
  g = {k: float(torch.linalg.vector_norm(got[k].double())) for k in names}
  w = {k: float(torch.linalg.vector_norm(want[k].double())) for k in names}
  median = statistics.median(w.values())
  return [abs(g[k] - w[k]) / max(w[k], median, 1e-30) for k in names]


def compare(config, traffic, pack, weights, loader_seed, losses,
            first_grads, params0, params3, control,
            device) -> List[check_lib.Check]:
  """The reference's first three updates from the same weights, raw data
  and keys, against the program's: each step's loss; the first
  gradient's norm, by its worst leaf (the program's gradient from its Adam
  state after one step); and the parameters' change after three steps, by
  its median leaf, leaving out leaves whose reference gradient is under a
  thousandth of the median leaf's (they move by round-off alone).  With
  ``control`` the reference in TF32 stands in for the program.  Returns
  the checks and the worst leaf's change gap (for the record)."""
  from perfbench.reference import threefry  # pylint: disable=import-outside-toplevel
  from perfbench.reference import train as ref_train  # pylint: disable=import-outside-toplevel
  from perfbench.reference.models.dim import ImitativeModel  # pylint: disable=import-outside-toplevel
  velocity = pack["velocity"].cpu().numpy()
  future = pack["player_future"].cpu().numpy()
  rows = ref_train.epoch_batches(
      int(traffic["samples"]), velocity, future,
      batch_size=int(traffic["batch"]), seed=loader_seed, epoch=0,
      val_fraction=traffic["val_fraction"],
      oversample=int(traffic["oversample_restarts"]))[:CHECK_STEPS]
  index = [torch.as_tensor(r, device=device) for r in rows]
  batches = [{k: v.index_select(0, i) for k, v in pack.items()}
             for i in index]
  rng = threefry.fold_in(threefry.PRNGKey(loader_seed, device), 1)

  def follow(tf32: bool):
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
      model = weights_lib.load(
          ImitativeModel(tuple(config["output_shape"]),
                         tuple(config["input_size"]), device="meta"),
          weights, device)
      got_losses, grads = ref_train.follow(
          model, batches, rng, traffic["lr"], traffic["velocity_dropout"])
      return got_losses, grads, {k: v.detach()
                                 for k, v in model.named_parameters()}
    finally:
      (torch.backends.cuda.matmul.allow_tf32,
       torch.backends.cudnn.allow_tf32) = flags

  want_losses, want_grads, want_params = follow(False)
  if control:
    losses, first_grads, params3 = follow(True)
  names = list(want_grads)
  grad_norms = {k: float(torch.linalg.vector_norm(want_grads[k].double()))
                for k in names}
  median = sorted(grad_norms.values())[len(names) // 2]
  moved = [k for k in names if grad_norms[k] >= 1e-3 * median]
  loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                 for a, b in zip(losses, want_losses))
  grad_gap = max(_leaf_norm_gaps(first_grads, want_grads, names))
  change = {k: params3[k] - params0[k] for k in moved}
  want_change = {k: want_params[k] - params0[k] for k in moved}
  change_gaps = _leaf_norm_gaps(change, want_change, moved)
  limits = traffic["limits"]
  checks = [
      check_lib.Check("loss_gap", loss_gap, limits["loss_gap"]),
      check_lib.Check("grad_norm_gap", grad_gap, limits["grad_norm_gap"]),
      check_lib.Check("change_norm_gap", statistics.median(change_gaps),
                      limits["change_norm_gap"]),
  ]
  return checks, max(change_gaps)
