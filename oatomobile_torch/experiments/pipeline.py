"""The learned-agent experiment: a Town01 collection mix whose traffic
densities match the benchmarks, RIP and CIL trained on it, then the
CARNOVEL and CoRL2017 tables of the batched policies.  Port of the JAX
package's ``scripts/experiment_r4.py``.

    python -m oatomobile_torch.experiments.pipeline [--cpu]

Phases are resumable: each writes its artifact and is skipped when the
artifact exists (the merged pack, ``rip/ckpts/ensemble-best``,
``cil/ckpts/model-best``, ``<suite>_<policy>/summary.json``).  Writes
``RUN_OUT/tables.json``.  The knobs are environment variables, read when
a phase runs (not at import), with the JAX script's names and defaults:

  RUN_OUT            output directory (default: a directory under the
                     system's temporary directory)
  RUN_EP_STEPS       steps of each collected episode (500)
  RUN_NOISE          the autopilot's epsilon-noise while collecting (0.2)
  RUN_EPOCHS         training epochs of RIP and CIL (40)
  RUN_BATCH          batch size (512)
  RUN_NUM_MODELS     RIP's ensemble size K (4)
  RUN_ACCUM          RIP's micro-batches per Adam step (2)
  RUN_EPISODES       CARNOVEL episodes per task (10)
  RUN_CORL_EPISODES  CoRL2017 episodes per task (3)
  RUN_MIX            JSON [[num_vehicles, num_episodes], ...] collection
                     mix (five densities, 0 to 100 vehicles)
  RUN_CHUNK          scenes per collection chunk (128)
  RUN_BRIDGE         JSON keyword arguments of the plan -> control bridge
  RUN_POLICIES       CARNOVEL policies, comma-separated
  RUN_CORL_POLICIES  CoRL2017 policies, comma-separated
  RUN_TABLES         the tables' file name (tables.json)
  RUN_HORIZON        the evaluation's horizon (1500, the suites' own; the
                     port's knob, for short runs)

``collect``, ``train`` and ``evaluate`` also take these knobs as keyword
arguments (a keyword given wins over the environment), and ``evaluate``
the suites' task dicts, so that a test or a smoke run can drive them
small.  Checkpoints are the port's ``.pt`` files or the
JAX package's ``.flax`` files (read without flax).
"""

import argparse
import contextlib
import dataclasses
import json
import os
import tempfile
import time
from typing import Callable, Dict, List, Mapping, Optional

HORIZON = 1500  # the batched evaluator's, the suites' own
# The plan -> control bridge's keyword arguments (RUN_BRIDGE's default).
BRIDGE = ('{"use_brake": true, "curvature_slowdown": true, '
          '"speed_gain": 1.2}')
EVAL_SEED = 7
T0 = time.time()
# The log lines' tag: the round whose script runs the phases (``log_tag``).
TAG = "r4"


def log(msg: str, tag: Optional[str] = None) -> None:
  print("[{} {:.0f}s] {}".format(tag or TAG, time.time() - T0, msg),
        flush=True)


@contextlib.contextmanager
def log_tag(tag: str):
  """Within the block the phases' log lines carry ``tag``."""
  global TAG
  before, TAG = TAG, tag
  try:
    yield
  finally:
    TAG = before


@dataclasses.dataclass
class Knobs:
  """The pipeline's knobs (module docstring)."""
  out: str
  ep_steps: int
  noise: float
  epochs: int
  batch: int
  num_models: int
  accum: int
  episodes: int
  corl_episodes: int
  mix: List[List[int]]
  chunk: int
  bridge: Dict
  policies: List[str]
  corl_policies: List[str]
  tables: str
  horizon: int


def _names(value: str) -> List[str]:
  return [p for p in value.split(",") if p]


def default_out(name: str) -> str:
  return os.path.join(tempfile.gettempdir(), "oatomobile_torch_" + name)


def knobs(defaults: Optional[Mapping[str, str]] = None,
          **overrides) -> Knobs:
  """The knobs from the environment now, with the given non-None
  ``overrides`` (``Knobs`` field names) in their place.  ``defaults``
  (``RUN_*`` name -> value) replaces this pipeline's default of a knob
  the environment does not set (another round's)."""
  defaults = defaults or {}

  def env(name, default):
    return os.environ.get(name, defaults.get(name, default))

  k = Knobs(
      out=env("RUN_OUT", default_out("r4")),
      ep_steps=int(env("RUN_EP_STEPS", 500)),
      noise=float(env("RUN_NOISE", 0.2)),
      epochs=int(env("RUN_EPOCHS", 40)),
      batch=int(env("RUN_BATCH", 512)),
      num_models=int(env("RUN_NUM_MODELS", 4)),
      # Microbatching: 2 x 256 is the same Adam step at half the
      # activation memory of a K = 4 backward at batch 512.
      accum=int(env("RUN_ACCUM", 2)),
      episodes=int(env("RUN_EPISODES", 10)),
      corl_episodes=int(env("RUN_CORL_EPISODES", 3)),
      # (num_vehicles, num_episodes): the benchmarks run 100-vehicle
      # traffic, so half the data comes from dense scenes.
      mix=json.loads(env(
          "RUN_MIX",
          "[[0, 384], [8, 512], [24, 512], [56, 640], [100, 768]]")),
      chunk=int(env("RUN_CHUNK", 128)),
      bridge=json.loads(env("RUN_BRIDGE", BRIDGE)),
      policies=_names(env("RUN_POLICIES",
                          "autopilot,cil,dim,rip_wcm,rip_ma,rip_bcm")),
      corl_policies=_names(env("RUN_CORL_POLICIES",
                               "autopilot,cil,dim,rip_wcm")),
      tables=env("RUN_TABLES", "tables.json"),
      horizon=int(env("RUN_HORIZON", HORIZON)))
  return dataclasses.replace(
      k, **{name: v for name, v in overrides.items() if v is not None})


# -- the phases -------------------------------------------------------------------


def collect(packed: str, *, out: Optional[str] = None, mix=None,
            ep_steps: Optional[int] = None, noise: Optional[float] = None,
            chunk: Optional[int] = None, image_size=(100, 100),
            device="cuda") -> None:
  """The collection mix, one pack per density (``OUT/pack_v<vehicles>``,
  seed ``1000 * (i + 1)`` for the mix's i-th entry), merged into
  ``packed``; skipped when ``packed`` (or a part) exists.  The images are
  packed at ``image_size`` (None: the sensors' own 200x200)."""
  from oatomobile_torch.datasets.carla import CARLADataset  # pylint: disable=import-outside-toplevel

  k = knobs(out=out, mix=mix, ep_steps=ep_steps, noise=noise, chunk=chunk)
  if CARLADataset.is_packed(packed):
    log("dataset exists: {}".format(packed))
    return
  parts = []
  for mix_i, (nv, eps) in enumerate(k.mix):
    part = os.path.join(k.out, "pack_v{}".format(nv))
    parts.append(part)
    if CARLADataset.is_packed(part):
      continue
    log("collect {} eps x {} steps, {} vehicles, noise={}".format(
        eps, k.ep_steps, nv, k.noise))
    n = CARLADataset.collect_packed(
        town="Town01", output_dir=part, num_episodes=eps,
        num_steps=k.ep_steps, num_vehicles=nv, noise=k.noise,
        seed=1000 * (mix_i + 1), chunk_episodes=k.chunk,
        image_size=image_size, device=device)
    log("  -> {} samples".format(n))
  total = CARLADataset.merge_packed(parts, packed)
  log("merged dataset: {} samples".format(total))


def train(packed: str, *, out: Optional[str] = None,
          num_models: Optional[int] = None, epochs: Optional[int] = None,
          batch: Optional[int] = None, accum: Optional[int] = None,
          device="cuda") -> None:
  """RIP (``num_models`` members, ``accum`` micro-batches) and CIL for
  ``epochs`` epochs each; a model whose ``best`` checkpoint exists is not
  trained again."""
  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.baselines.learned.cil.train import train as cil_train
  from oatomobile_torch.baselines.learned.rip.train import train as rip_train

  k = knobs(out=out, num_models=num_models, epochs=epochs, batch=batch,
            accum=accum)
  if not has_best(os.path.join(k.out, "rip", "ckpts"), "ensemble"):
    log("train RIP K={}, {} epochs, batch {}".format(k.num_models, k.epochs,
                                                     k.batch))
    rip_train(packed, os.path.join(k.out, "rip"), num_models=k.num_models,
              batch_size=k.batch, num_epochs=k.epochs, grad_accum=k.accum,
              device=device)
  else:
    log("ensemble-best exists")

  if not has_best(os.path.join(k.out, "cil", "ckpts"), "model"):
    log("train CIL, {} epochs, batch {}".format(k.epochs, k.batch))
    cil_train(packed, os.path.join(k.out, "cil"), batch_size=k.batch,
              num_epochs=k.epochs, device=device)
  else:
    log("cil-best exists")


# -- checkpoints of either package -----------------------------------------------


def has_best(ckpt_dir: str, prefix: str) -> bool:
  return any(os.path.exists(os.path.join(ckpt_dir, prefix + "-best" + ext))
             for ext in (".pt", ".flax"))


def checkpoint_path(ckpt_dir: str, prefix: str, name) -> str:
  """The path of ``{prefix}-{name}`` (a name or an epoch): the port's
  ``.pt`` if there is one, else the JAX package's ``.flax``."""
  for ext in (".pt", ".flax"):
    path = os.path.join(ckpt_dir, "{}-{}{}".format(prefix, name, ext))
    if os.path.exists(path):
      return path
  raise FileNotFoundError("no {}-{}.pt or .flax in {}".format(
      prefix, name, ckpt_dir))


def latest_epoch(ckpt_dir: str, prefix: str) -> Optional[int]:
  """The newest periodic checkpoint's epoch, of either package."""
  import re  # pylint: disable=import-outside-toplevel
  pattern = re.compile(r"^{}-(\d+)\.(pt|flax)$".format(re.escape(prefix)))
  epochs = [int(m.group(1)) for m in map(pattern.match,
                                         os.listdir(ckpt_dir)) if m]
  return max(epochs) if epochs else None


def read_ensemble(ckpt_dir: str, name="best", device="cuda") -> list:
  """The K ``ImitativeModel((4, 2))`` members of the stacked ensemble
  checkpoint ``ensemble-{name}`` (a name or an epoch), on ``device``."""
  # pylint: disable=import-outside-toplevel
  import numpy as np
  from oatomobile_torch.baselines.learned.rip.train import unstack_params
  from oatomobile_torch.models import convert
  from oatomobile_torch.models.dim import ImitativeModel
  from oatomobile_torch.utils import checkpoint, flax_msgpack

  path = checkpoint_path(ckpt_dir, "ensemble", name)
  if path.endswith(".flax"):
    tree = flax_msgpack.read(path)

    def member(node, k):
      if isinstance(node, dict):
        return {key: member(v, k) for key, v in node.items()}
      return np.asarray(node)[k]

    first = tree
    while isinstance(first, dict):
      first = next(iter(first.values()))
    states = [convert.state_dict(member(tree, k))
              for k in range(np.shape(first)[0])]
  else:
    stacked = checkpoint.load_file(path)
    states = [unstack_params(stacked, k)
              for k in range(next(iter(stacked.values())).shape[0])]
  models = []
  for state in states:
    model = ImitativeModel(output_shape=(4, 2), device=device)
    model.load_state_dict(state, strict=True)
    models.append(model)
  return models


def read_cil(ckpt_dir: str, device="cuda"):
  """CIL's ``BehaviouralModel((40, 2))`` of ``model-best``, on ``device``."""
  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.models.cil import BehaviouralModel
  from oatomobile_torch.utils.checkpoint import read_params
  return read_params(checkpoint_path(ckpt_dir, "model", "best"),
                     BehaviouralModel(output_shape=(40, 2), device=device))


def policies(*, out: Optional[str] = None, num_models: Optional[int] = None,
             bridge: Optional[Mapping] = None,
             device="cuda") -> Dict[str, Callable]:
  """name -> a factory of the batched policy (``None`` for the
  autopilot): CIL from ``cil/ckpts``; DIM (member 0) and RIP-WCM/MA/BCM
  from the ensemble in ``rip/ckpts``, 20 plan steps; every learned policy
  with the ``bridge`` knobs.  Checkpoints are read when a factory runs."""
  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.baselines.learned.cil.policy import make_cil_policy
  from oatomobile_torch.baselines.learned.dim.policy import make_dim_policy
  from oatomobile_torch.baselines.learned.rip.policy import make_rip_policy

  k = knobs(out=out, num_models=num_models, bridge=bridge)
  rip_dir = os.path.join(k.out, "rip", "ckpts")

  def ensemble():
    models = read_ensemble(rip_dir, device=device)
    if len(models) != k.num_models:
      raise ValueError("{} holds {} members, RUN_NUM_MODELS is {}".format(
          rip_dir, len(models), k.num_models))
    return models

  def rip(algorithm):
    return lambda: make_rip_policy(ensemble(), algorithm=algorithm,
                                   num_plan_steps=20, **k.bridge)

  return {
      "autopilot": lambda: None,
      "cil": lambda: make_cil_policy(
          read_cil(os.path.join(k.out, "cil", "ckpts"), device), **k.bridge),
      "dim": lambda: make_dim_policy(ensemble()[0], num_plan_steps=20,
                                     **k.bridge),
      "rip_wcm": rip("WCM"),
      "rip_ma": rip("MA"),
      "rip_bcm": rip("BCM"),
  }


def train_log(train_dir: str, label: str = "dim") -> List[Dict]:
  """A trainer's epoch records (``<train_dir>/logs/<label>_train.jsonl``)."""
  with open(os.path.join(train_dir, "logs", label + "_train.jsonl")) as fp:
    return [json.loads(line) for line in fp]


def read_summary(path: str) -> Dict:
  """The ``summary`` of an ``evaluate_batched`` summary.json."""
  with open(path) as fp:
    return json.load(fp)["summary"]


def suites() -> Dict[str, Mapping]:
  """The suites' task dicts: CARNOVEL's 27 and CoRL2017's 150."""
  # pylint: disable=import-outside-toplevel
  from oatomobile_torch.benchmarks.carnovel.benchmark import _TASKS as carnovel
  from oatomobile_torch.benchmarks.corl2017.benchmark import _TASKS as corl
  return {"carnovel": carnovel, "corl2017": corl}


def evaluate(*, out: Optional[str] = None,
             carnovel_policies: Optional[List[str]] = None,
             corl_policies: Optional[List[str]] = None,
             episodes: Optional[int] = None,
             corl_episodes: Optional[int] = None,
             tables: Optional[str] = None,
             num_models: Optional[int] = None,
             bridge: Optional[Mapping] = None,
             horizon: Optional[int] = None,
             carnovel_tasks: Optional[Mapping] = None,
             corl_tasks: Optional[Mapping] = None,
             device="cuda") -> Dict[str, Dict]:
  """Each suite's policies through ``evaluate_batched`` (seed 7), each
  into ``OUT/<suite>_<policy>/`` (metrics.csv per task, summary.json);
  a policy whose summary exists is read, not run again.  Writes the
  summaries to ``OUT/<tables>`` (``{suite: {policy: summary}}``) after
  each new row and returns them."""
  from oatomobile_torch.benchmarks.batched_eval import evaluate_batched  # pylint: disable=import-outside-toplevel

  k = knobs(out=out, policies=carnovel_policies, corl_policies=corl_policies,
            episodes=episodes, corl_episodes=corl_episodes, tables=tables,
            num_models=num_models, bridge=bridge, horizon=horizon)
  tasks = suites()
  tasks = {"carnovel": tasks["carnovel"] if carnovel_tasks is None
                       else carnovel_tasks,
           "corl2017": tasks["corl2017"] if corl_tasks is None
                       else corl_tasks}
  factories = policies(out=k.out, num_models=k.num_models, bridge=k.bridge,
                       device=device)
  table = {}
  path = os.path.join(k.out, k.tables)
  if os.path.exists(path):
    with open(path) as fp:
      table = json.load(fp)

  runs = ([("carnovel", k.episodes, n) for n in k.policies] +
          [("corl2017", k.corl_episodes, n) for n in k.corl_policies])
  for suite, num_episodes, name in runs:
    key = "{}_{}".format(suite, name)
    log_dir = os.path.join(k.out, key)
    summary_path = os.path.join(log_dir, "summary.json")
    if os.path.exists(summary_path):
      table.setdefault(suite, {})[name] = read_summary(summary_path)
      continue
    log("evaluating {} ({} episodes/task)".format(key, num_episodes))
    evaluate_batched(tasks[suite], policy_fn=factories[name](),
                     log_dir=log_dir, horizon=k.horizon,
                     num_episodes=num_episodes, seed=EVAL_SEED, device=device)
    summary = read_summary(summary_path)
    table.setdefault(suite, {})[name] = summary
    log("{}: success {:.1%} +- {:.1%} | collision {:.1%} | timeout {:.1%}"
        .format(key, summary["success_rate"], summary["success_ci95"],
                summary["collision_rate"], summary["timeout_rate"]))
    with open(path, "w") as fp:
      json.dump(table, fp, indent=2)
  log("done: {}".format(path))
  return table


def parse_device(description: str, argv=None) -> str:
  """``--cpu`` from the command line: the device of an experiment's run."""
  parser = argparse.ArgumentParser(description=description)
  parser.add_argument("--cpu", action="store_true",
                      help="run on the CPU (default: the CUDA card)")
  return "cpu" if parser.parse_args(argv).cpu else "cuda"


def main(argv=None) -> None:
  device = parse_device(__doc__.splitlines()[0], argv)
  k = knobs()
  os.makedirs(k.out, exist_ok=True)
  packed = os.path.join(k.out, "packed")
  collect(packed, device=device)
  train(packed, device=device)
  evaluate(device=device)


if __name__ == "__main__":
  main()
