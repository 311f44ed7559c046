"""The round-2 learned-agent experiment: a mixed-traffic expert
collection, a K = 4 RIP ensemble (the val-selected best checkpoint), and
the CARNOVEL agent comparison.  Port of the JAX package's
``scripts/experiment_r2.py``.

    python -m oatomobile_torch.experiments.round2 [--cpu]

Phases are resumable: the merged pack and ``rip/ckpts/ensemble-best`` are
made once.  The evaluation is not: every policy of ``RUN_POLICIES`` runs
again on every call, over CARNOVEL's 27 tasks at one episode a task and
seed 0, and its summary replaces the policy's row of the flat
``RUN_OUT/agents_summary.json`` (``{policy: summary}``), written after
each row.  It reads ``ensemble-best``, else the newest periodic
checkpoint; DIM is member 0 at 20 plan steps, RIP-WCM/MA/BCM run
``make_rip_policy``'s 10.

Differences from ``pipeline`` (round 4): the pack holds the LIDAR at its
200x200 (no ``image_size``; the model downsamples it), collected 16 scenes
a chunk; RIP alone is trained, with no gradient accumulation.

Knobs (environment variables read when a phase runs, with the JAX
script's names and defaults; each phase also takes them as keywords):
RUN_OUT (a directory under the system's temporary directory),
RUN_EP_STEPS (500), RUN_NOISE (0.2), RUN_EPOCHS (80), RUN_BATCH (512),
RUN_MIX (``[[0, 64], [8, 128], [24, 64]]``), RUN_BRIDGE (``pipeline``'s),
RUN_POLICIES (``autopilot,dim,rip_wcm,rip_ma``), and the port's
RUN_HORIZON (1500) for short runs.  Checkpoints are the port's ``.pt``
files or the JAX package's ``.flax`` files.
"""

import json
import os
from typing import Dict, List, Mapping, Optional

from oatomobile_torch.experiments import pipeline

DEFAULTS = {
    "RUN_OUT": pipeline.default_out("r2"),
    "RUN_EPOCHS": "80",
    "RUN_MIX": "[[0, 64], [8, 128], [24, 64]]",
    "RUN_POLICIES": "autopilot,dim,rip_wcm,rip_ma",
}
TAG = "r2"
NUM_MODELS = 4
CHUNK = 16
DIM_PLAN_STEPS = 20


def knobs(**overrides) -> pipeline.Knobs:
  """``pipeline.knobs`` with round 2's defaults."""
  return pipeline.knobs(defaults=DEFAULTS, **overrides)


def log(msg: str) -> None:
  pipeline.log(msg, tag=TAG)


def collect(packed: str, *, out: Optional[str] = None, mix=None,
            ep_steps: Optional[int] = None, noise: Optional[float] = None,
            device="cuda") -> None:
  """The collection mix (``pipeline.collect``) at the sensors' 200x200, 16
  scenes a chunk."""
  k = knobs(out=out, mix=mix, ep_steps=ep_steps, noise=noise)
  with pipeline.log_tag(TAG):
    pipeline.collect(packed, out=k.out, mix=k.mix, ep_steps=k.ep_steps,
                     noise=k.noise, chunk=CHUNK, image_size=None,
                     device=device)


def train(packed: str, *, out: Optional[str] = None,
          epochs: Optional[int] = None, batch: Optional[int] = None,
          device="cuda") -> None:
  """RIP with K = 4 for ``epochs`` epochs, unless ``ensemble-best``
  exists; logs the first and last epochs' loss and the best val loss."""
  from oatomobile_torch.baselines.learned.rip.train import train as rip_train  # pylint: disable=import-outside-toplevel

  k = knobs(out=out, epochs=epochs, batch=batch)
  if pipeline.has_best(os.path.join(k.out, "rip", "ckpts"), "ensemble"):
    log("ensemble-best exists")
    return
  log("train RIP K={}, {} epochs, batch {}".format(NUM_MODELS, k.epochs,
                                                   k.batch))
  rip_train(packed, os.path.join(k.out, "rip"), num_models=NUM_MODELS,
            batch_size=k.batch, num_epochs=k.epochs, device=device)
  records = pipeline.train_log(os.path.join(k.out, "rip"), "rip")
  log("train loss: {} -> {}; best val {}".format(
      round(records[0]["loss"], 2), round(records[-1]["loss"], 2),
      round(min(r.get("val_loss", float("inf")) for r in records), 2)))


def read_members(ckpt_dir: str, device="cuda") -> list:
  """The ensemble's members from ``ensemble-best``, else from the newest
  periodic checkpoint."""
  if pipeline.has_best(ckpt_dir, "ensemble"):
    members = pipeline.read_ensemble(ckpt_dir, "best", device=device)
    log("loaded ensemble-best")
  else:
    epoch = pipeline.latest_epoch(ckpt_dir, "ensemble")
    if epoch is None:
      raise FileNotFoundError("no ensemble checkpoint in {}".format(
          ckpt_dir))
    members = pipeline.read_ensemble(ckpt_dir, epoch, device=device)
    log("loaded ensemble epoch {}".format(epoch))
  if len(members) != NUM_MODELS:
    raise ValueError("{} holds {} members; round 2's ensemble has {}".format(
        ckpt_dir, len(members), NUM_MODELS))
  return members


def evaluate(*, out: Optional[str] = None,
             policies: Optional[List[str]] = None,
             bridge: Optional[Mapping] = None,
             horizon: Optional[int] = None,
             tasks: Optional[Mapping] = None,
             device="cuda") -> Dict[str, Dict]:
  """Each policy through ``evaluate_batched`` over CARNOVEL (or
  ``tasks``) into ``OUT/carnovel_<policy>/``, run again whether or not
  its summary exists; returns and writes ``agents_summary.json``."""
  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.baselines.learned.dim.policy import make_dim_policy
  from oatomobile_torch.baselines.learned.rip.policy import make_rip_policy
  from oatomobile_torch.benchmarks.batched_eval import evaluate_batched

  k = knobs(out=out, policies=policies, bridge=bridge, horizon=horizon)
  if tasks is None:
    tasks = pipeline.suites()["carnovel"]
  members = read_members(os.path.join(k.out, "rip", "ckpts"), device)
  factories = {
      "autopilot": lambda: None,
      "dim": lambda: make_dim_policy(members[0],
                                     num_plan_steps=DIM_PLAN_STEPS,
                                     **k.bridge),
  }
  for name in ("wcm", "ma", "bcm"):
    factories["rip_" + name] = (
        lambda algorithm=name.upper(): make_rip_policy(
            members, algorithm=algorithm, **k.bridge))

  table = {}
  summary_path = os.path.join(k.out, "agents_summary.json")
  if os.path.exists(summary_path):
    with open(summary_path) as fp:
      table = json.load(fp)
  for name in k.policies:
    log("evaluating {}".format(name))
    log_dir = os.path.join(k.out, "carnovel_" + name)
    evaluate_batched(tasks, policy_fn=factories[name](), log_dir=log_dir,
                     horizon=k.horizon, device=device)
    table[name] = pipeline.read_summary(os.path.join(log_dir,
                                                     "summary.json"))
    log("{}: {}".format(name, table[name]))
    with open(summary_path, "w") as fp:
      json.dump(table, fp, indent=2)
  log("done: {}".format(summary_path))
  return table


def main(argv=None) -> None:
  device = pipeline.parse_device(__doc__.splitlines()[0], argv)
  k = knobs()
  os.makedirs(k.out, exist_ok=True)
  packed = os.path.join(k.out, "packed")
  collect(packed, device=device)
  train(packed, device=device)
  evaluate(device=device)


if __name__ == "__main__":
  main()
