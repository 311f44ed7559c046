"""The port's surface against the JAX package's, read from both packages'
sources with ``ast`` (neither package is imported, so no JAX here).

Each module of ``oatomobile_tpu/`` is paired with the port's module of the
same path (``RENAMES`` aside), which must have:

- every public top-level function and class, and every method (private
  ones too; dunders apart from ``__init__``), class-level alias and
  dataclass field of those classes (a field may be an ``__init__``
  argument or a ``self.`` attribute in the port);
- every argument name of each matched function or method, or ``**kwargs``;
- every name that a package ``__init__`` exports.

Each of the JAX package's ``scripts/*.py`` is paired with its module under
``oatomobile_torch/experiments/`` (``SCRIPT_MODULES``), which, with the
experiment modules it imports, must read every ``--flag`` and environment
knob that the script reads.

``ALLOWLIST`` holds the JAX names whose counterpart in the port has another
name or form: each entry names that counterpart, which must exist, and
says why.  When the JAX package gains a name, port it, or add it here with
its counterpart and reason.
"""

import ast
import functools
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX = ROOT / "oatomobile_tpu"
PORT = ROOT / "oatomobile_torch"
SCRIPTS = ROOT / "scripts"
EXPERIMENTS = PORT / "experiments"

# JAX module path (or directory prefix) -> the port's.
RENAMES = {"ops/bev_pallas.py": "ops/bev_cuda.py",
           "simulators/tpu/": "simulators/cuda/"}
# A JAX script's flag -> the port's.
FLAG_RENAMES = {"--platform": "--cpu"}
# Each JAX script -> the module under oatomobile_torch/experiments that
# ports it.
SCRIPT_MODULES = {
    "demo_dashboard.py": "demo_dashboard",
    "demo_full_loop.py": "demo_full_loop",
    "diag_busytown.py": "diag.busytown",
    "diag_busytown_viz.py": "diag.busytown_viz",
    "diag_hero_stops.py": "diag.hero_stops",
    "diag_hills.py": "diag.hills",
    "diag_hills_viz.py": "diag.hills_viz",
    "diag_learned_failures.py": "diag.learned_failures",
    "diag_stalls.py": "diag.stalls",
    "diag_town02.py": "diag.town02",
    "eval_carnovel_agents.py": "eval_carnovel_agents",
    "eval_rip_sweep.py": "rip_sweep",
    "experiment_r2.py": "round2",
    "experiment_r3.py": "round3",
    "experiment_r4.py": "pipeline",
    "experiment_r5.py": "round5",
    "headtohead_r5.py": "headtohead",
    "post_experiment.py": "post_round2",
    "post_experiment_r3.py": "publish_r3",
    "post_experiment_r4.py": "publish_r4",
    "post_experiment_r5.py": "publish",
    "profile_flow.py": "profile_flow",
    "study_dim50.py": "study_dim50",
    "train_dim_full.py": "train_dim_full",
    "train_in_the_loop.py": "train_in_the_loop",
}

_PARAMS = ("the flax module and its parameter tree are one nn.Module in the "
           "port: weights live in the module (models/convert.py carries "
           "the JAX weights over)")
_OPTIMIZER = ("the optax transformation and its state are the "
              "torch.optim.Optimizer that TrainState holds")
_SETUP = ("flax builds submodules in setup(); an nn.Module builds them in "
          "__init__")
_XP = ("the JAX functions take the array module as xp=; the port's "
       "dispatch on the input's type (numpy or torch)")
_SPLAT = ("the Pallas wrapper over a scene batch: the port gathers the "
          "kernel's inputs in ops/bev and launches the CUDA kernel from "
          "ops/bev_cuda; interpret mode is JAX-only (a CPU tensor takes "
          "the plain version)")
_TPU_SIM = ("the single-scene backend on the port's device: CUDASimulator "
            "is TPUSimulator's counterpart")

# "JAX path::name" -> ("port path::name", why).  Keys as the gaps read:
# "module.py", "module.py::Name", "module.py::Class.member",
# "module.py::function(argument)", "package/__init__.py::__all__[name]".
ALLOWLIST = {
    "_metadata.py": (
        "__init__.py::__version__",
        "the module holds only __version__; the package's __init__ does"),
    "utils/platform.py": (
        "device.py::resolve",
        "enable_compilation_cache and force_cpu switch JAX's platform and "
        "compile cache; the port picks its device per call"),
    "ops/bev_pallas.py::splat_lidar_pallas": (
        "ops/bev_cuda.py::splat_lidar_batch", _SPLAT),
    "ops/bev_pallas.py::splat_lidar_batch(interpret)": (
        "ops/bev_cuda.py::splat_lidar_batch", _SPLAT),
    "ops/bev_pallas.py::gather_inputs": ("ops/bev.py::gather_inputs",
                                         _SPLAT),
    "simulators/tpu/simulator.py::TPUSimulator": (
        "simulators/cuda/simulator.py::CUDASimulator", _TPU_SIM),
    "simulators/tpu/__init__.py::__all__[TPUSimulator]": (
        "simulators/cuda/__init__.py::CUDASimulator", _TPU_SIM),
    "simulators/__init__.py::__all__[TPUSimulator]": (
        "simulators/__init__.py::CUDASimulator", _TPU_SIM),
    "envs/batched.py::BatchedEnv._compile_step": (
        "envs/batched.py::BatchedEnv._make_rollout_step",
        "the jitted step is a graphs.CapturedStep, made per rollout"),
    "envs/batched.py::BatchedEnv._reset_where_done(initial)": (
        "envs/batched.py::BatchedEnv._initial",
        "the initial scenes are the env's own static buffer"),
    "datasets/carla.py::CARLADataset.as_jax": (
        "datasets/carla.py::CARLADataset.as_numpy_batched",
        "host batches for the device; as_torch gives tensors"),
    "datasets/carla.py::CARLADataset.as_jax_packed": (
        "datasets/carla.py::CARLADataset.as_numpy_packed",
        "the packed dataset's batches, moved to the device by the trainer"),
    "baselines/learned/cil/policy.py::mode_from_goal_jnp": (
        "baselines/learned/cil/policy.py::mode_from_goal",
        "the jnp twin of a host function; the port has one function"),
    "baselines/learned/cil/train.py::mode_labels_jnp": (
        "baselines/learned/cil/train.py::mode_labels",
        "the jnp twin of a host function; the port has one function"),
    "maps/assets.py::TownMap.device_arrays": (
        "maps/assets.py::TownMap.tensors",
        "the map's arrays on a device the caller names"),
    "models/cil.py::BehaviouralModel.setup": (
        "models/cil.py::BehaviouralModel.__init__", _SETUP),
    "models/dim.py::ImitativeModel.setup": (
        "models/dim.py::ImitativeModel.__init__", _SETUP),
    "models/sequence.py::AutoregressiveFlow.setup": (
        "models/sequence.py::AutoregressiveFlow.__init__", _SETUP),
    "ops/transforms.py::rot2mat(xp)": ("ops/transforms.py::_is_torch", _XP),
    "ops/transforms.py::world2local(xp)": ("ops/transforms.py::_is_torch",
                                           _XP),
    "ops/transforms.py::local2world(xp)": ("ops/transforms.py::_is_torch",
                                           _XP),
    "ops/transforms.py::yaw_to_forward(xp)": (
        "ops/transforms.py::_is_torch", _XP),
    "ops/transforms.py::world2local_2d(xp)": (
        "ops/transforms.py::_is_torch", _XP),
    "ops/transforms.py::local2world_2d(xp)": (
        "ops/transforms.py::_is_torch", _XP),
    "baselines/learned/cil/policy.py::make_cil_policy(model_params)": (
        "baselines/learned/cil/policy.py::make_cil_policy", _PARAMS),
    "baselines/learned/rip/agent.py::stack_ensemble(params_list)": (
        "baselines/learned/rip/agent.py::stack_ensemble", _PARAMS),
    "baselines/learned/rip/agent.py::rip_plan(model)": (
        "baselines/learned/rip/agent.py::rip_plan", _PARAMS),
    "baselines/learned/rip/agent.py::rip_plan(stacked_params)": (
        "baselines/learned/rip/agent.py::rip_plan", _PARAMS),
    "baselines/learned/rip/agent.py::rip_plan(encoder_dtype)": (
        "baselines/learned/rip/agent.py::rip_plan",
        "encoders= takes the members at the encoder's precision, from "
        "dim.policy.encoder_copy (make_rip_policy makes them once)"),
    "baselines/learned/rip/policy.py::make_rip_policy(model)": (
        "baselines/learned/rip/policy.py::make_rip_policy", _PARAMS),
    "baselines/learned/rip/policy.py::make_rip_policy(stacked_params)": (
        "baselines/learned/rip/policy.py::make_rip_policy", _PARAMS),
    "parallel/dp.py::TrainState.params": ("parallel/dp.py::TrainState.model",
                                          _PARAMS),
    "parallel/dp.py::TrainState.opt_state": (
        "parallel/dp.py::TrainState.optimizer", _OPTIMIZER),
    "parallel/dp.py::TrainState.create(params)": (
        "parallel/dp.py::TrainState.create", _PARAMS),
    "parallel/dp.py::make_update_fn(optimizer)": (
        "parallel/dp.py::TrainState.optimizer", _OPTIMIZER),
}

_FUNCTIONS = (ast.FunctionDef, ast.AsyncFunctionDef)


@functools.lru_cache(maxsize=None)
def _tree(path: Path) -> ast.Module:
  return ast.parse(path.read_text(), filename=str(path))


def _port_rel(rel: str) -> str:
  for old, new in RENAMES.items():
    if rel == old or (old.endswith("/") and rel.startswith(old)):
      return new + rel[len(old):]
  return rel


def _port_rel_name(name: str) -> str:
  """An exported submodule's name in the port (``bev_pallas`` is
  ``bev_cuda``)."""
  for old, new in RENAMES.items():
    if old.endswith(".py") and old.rsplit("/", 1)[-1] == name + ".py":
      return new.rsplit("/", 1)[-1][:-3]
  return name


def _is_private(name: str) -> bool:
  return name.startswith("_")


def _is_dunder(name: str) -> bool:
  return name.startswith("__") and name.endswith("__")


def _bindings(body) -> dict:
  """Top-level name -> node: defs, classes, assignments and imports,
  also under ``if``/``try``."""
  out = {}
  for node in body:
    if isinstance(node, _FUNCTIONS + (ast.ClassDef,)):
      out[node.name] = node
    elif isinstance(node, ast.Assign):
      for target in node.targets:
        for n in ast.walk(target):
          if isinstance(n, ast.Name):
            out.setdefault(n.id, node)
    elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                        ast.Name):
      out.setdefault(node.target.id, node)
    elif isinstance(node, (ast.Import, ast.ImportFrom)):
      for alias in node.names:
        out.setdefault((alias.asname or alias.name).split(".")[0], node)
    elif isinstance(node, (ast.If, ast.Try)):
      inner = list(node.body) + list(node.orelse)
      for handler in getattr(node, "handlers", ()):
        inner += handler.body
      for name, n in _bindings(inner).items():
        out.setdefault(name, n)
  return out


def _members(cls: ast.ClassDef) -> dict:
  """Class-body name -> node: methods, aliases and annotated fields."""
  out = {}
  for node in cls.body:
    if isinstance(node, _FUNCTIONS):
      out[node.name] = node
    elif isinstance(node, ast.Assign):
      for target in node.targets:
        if isinstance(target, ast.Name):
          out[target.id] = node
    elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                        ast.Name):
      out[node.target.id] = node
  return out


def _self_attributes(cls: ast.ClassDef) -> set:
  """Names assigned as ``self.<name>`` in the class's methods."""
  out = set()
  for node in ast.walk(cls):
    targets = node.targets if isinstance(node, ast.Assign) else \
        [node.target] if isinstance(node, (ast.AnnAssign,
                                           ast.AugAssign)) else []
    for t in targets:
      if (isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name)
          and t.value.id == "self"):
        out.add(t.attr)
  return out


@functools.lru_cache(maxsize=None)
def _port_classes() -> dict:
  """Every class of the port by name, to follow base classes."""
  out = {}
  for path in sorted(PORT.rglob("*.py")):
    for node in ast.walk(_tree(path)):
      if isinstance(node, ast.ClassDef):
        out.setdefault(node.name, []).append(node)
  return out


def _base_name(node):
  if isinstance(node, ast.Name):
    return node.id
  if isinstance(node, ast.Attribute):
    return node.attr
  if isinstance(node, ast.Subscript):
    return _base_name(node.value)
  return None


def _port_member(cls: ast.ClassDef, name: str, seen=None):
  """The port class's member ``name``, its own or a port base class's."""
  seen = set() if seen is None else seen
  if id(cls) in seen:
    return None
  seen.add(id(cls))
  own = _members(cls)
  if name in own:
    return own[name]
  for base in cls.bases:
    for parent in _port_classes().get(_base_name(base), ()):
      found = _port_member(parent, name, seen)
      if found is not None:
        return found
  return None


def _has_field(cls: ast.ClassDef, name: str) -> bool:
  """A JAX dataclass field's counterpart: a member, an ``__init__``
  argument or a ``self.`` attribute of the port class."""
  if _port_member(cls, name) is not None or name in _self_attributes(cls):
    return True
  init = _port_member(cls, "__init__")
  return isinstance(init, _FUNCTIONS) and name in _arguments(init)[0]


def _arguments(fn):
  a = fn.args
  names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
  return [n for n in names if n not in ("self", "cls")], a.vararg, a.kwarg


def _argument_gaps(where: str, jax_fn, port_fn) -> list:
  if not (isinstance(jax_fn, _FUNCTIONS) and isinstance(port_fn, _FUNCTIONS)):
    return []
  names, vararg, kwarg = _arguments(jax_fn)
  port_names, port_vararg, port_kwarg = _arguments(port_fn)
  gaps = [f"{where}({n})" for n in names
          if n not in port_names and port_kwarg is None]
  if vararg is not None and port_vararg is None:
    gaps.append(f"{where}(*{vararg.arg})")
  if kwarg is not None and port_kwarg is None:
    gaps.append(f"{where}(**{kwarg.arg})")
  return gaps


def _exports(tree: ast.Module) -> set:
  for node in tree.body:
    if isinstance(node, ast.Assign) and any(
        isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
      return set(ast.literal_eval(node.value))
  return {n for n in _bindings(tree.body) if not _is_private(n)}


def _class_gaps(where: str, cls: ast.ClassDef, port_cls: ast.ClassDef):
  gaps = []
  for name, node in _members(cls).items():
    if _is_dunder(name) and name != "__init__":
      continue
    member = f"{where}.{name}"
    if isinstance(node, ast.AnnAssign):
      if not _has_field(port_cls, name):
        gaps.append(member)
      continue
    port_node = _port_member(port_cls, name)
    if port_node is None:
      if name != "__init__":
        gaps.append(member)
      continue
    gaps += _argument_gaps(member, node, port_node)
  return gaps


def module_gaps(rel: str) -> list:
  """What the JAX module ``rel`` (a path under ``oatomobile_tpu/``) has and
  its port lacks, as ALLOWLIST keys."""
  port_path = PORT / _port_rel(rel)
  if not port_path.exists():
    return [rel]
  tree, port_tree = _tree(JAX / rel), _tree(port_path)
  port = _bindings(port_tree.body)
  gaps = []
  for node in tree.body:
    if not isinstance(node, _FUNCTIONS + (ast.ClassDef,)) or \
        _is_private(node.name):
      continue
    where = f"{rel}::{node.name}"
    port_node = port.get(node.name)
    if port_node is None:
      gaps.append(where)
    elif isinstance(node, ast.ClassDef):
      if isinstance(port_node, ast.ClassDef):
        gaps += _class_gaps(where, node, port_node)
    else:
      gaps += _argument_gaps(where, node, port_node)
  if rel.endswith("__init__.py"):
    port_exports = _exports(port_tree)
    gaps += [f"{rel}::__all__[{name}]"
             for name in sorted(_exports(tree))
             if _port_rel_name(name) not in port_exports]
  return gaps


def _resolve(counterpart: str) -> bool:
  """Whether ``path::Name`` or ``path::Class.member`` is in the port."""
  path, _, name = counterpart.partition("::")
  file = PORT / path
  if not file.exists():
    return False
  top, _, member = name.partition(".")
  node = _bindings(_tree(file).body).get(top)
  if node is None or not member:
    return node is not None
  return isinstance(node, ast.ClassDef) and _has_field(node, member)


JAX_MODULES = sorted(p.relative_to(JAX).as_posix() for p in JAX.rglob("*.py"))


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_port_has_the_jax_module_surface(rel):
  missing = [g for g in module_gaps(rel) if g not in ALLOWLIST]
  assert not missing, (
      "the JAX package's {} has names with no counterpart in "
      "oatomobile_torch/{} (port them, or add each to ALLOWLIST with its "
      "counterpart and reason): {}".format(rel, _port_rel(rel), missing))


@pytest.mark.parametrize("key", sorted(ALLOWLIST))
def test_allowlist_entry_is_a_gap_with_a_counterpart(key):
  rel = key.split("::")[0]
  assert key in module_gaps(rel), (
      f"{key} is no longer a gap: remove it from ALLOWLIST")
  counterpart, reason = ALLOWLIST[key]
  assert _resolve(counterpart), (
      f"{key}'s counterpart oatomobile_torch/{counterpart} does not exist")
  assert reason.strip()


def _experiment_file(dotted: str) -> Path:
  return EXPERIMENTS.joinpath(*dotted.split(".")).with_suffix(".py")


def _imported_experiments(tree: ast.Module) -> set:
  """The ``oatomobile_torch.experiments`` modules that ``tree`` imports,
  dotted below that package."""
  prefix = "oatomobile_torch.experiments"
  out = set()
  for node in ast.walk(tree):
    if isinstance(node, ast.ImportFrom) and node.module and \
        node.module.startswith(prefix):
      base = node.module[len(prefix):].lstrip(".")
      for alias in node.names:
        dotted = ".".join(p for p in (base, alias.name) if p)
        if _experiment_file(dotted).exists():
          out.add(dotted)
        elif base and _experiment_file(base).exists():
          out.add(base)
    elif isinstance(node, ast.Import):
      for alias in node.names:
        if alias.name.startswith(prefix + "."):
          dotted = alias.name[len(prefix) + 1:]
          if _experiment_file(dotted).exists():
            out.add(dotted)
  return out


def _with_imports(dotted: str) -> list:
  """``dotted`` and the experiment modules it imports, transitively."""
  seen, todo = [], [dotted]
  while todo:
    name = todo.pop()
    if name in seen:
      continue
    seen.append(name)
    todo += sorted(_imported_experiments(_tree(_experiment_file(name))))
  return seen


def _call_name(func):
  if isinstance(func, ast.Name):
    return func.id
  if isinstance(func, ast.Attribute):
    return func.attr
  return None


def _first_string(call: ast.Call):
  if call.args and isinstance(call.args[0], ast.Constant) and isinstance(
      call.args[0].value, str):
    return call.args[0].value
  return None


def _flags(tree: ast.Module) -> set:
  out = set()
  for node in ast.walk(tree):
    if isinstance(node, ast.Call) and _call_name(node.func) == \
        "add_argument":
      out |= {a.value for a in node.args
              if isinstance(a, ast.Constant) and isinstance(a.value, str)
              and a.value.startswith("-")}
  return out


def _environ_read(node):
  """The name that ``node`` reads from the environment, if it is
  ``os.environ.get``/``setdefault(name)``, ``os.environ[name]`` or
  ``os.getenv(name)``."""
  if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
    owner = node.func.value
    environ = isinstance(owner, ast.Attribute) and owner.attr == "environ"
    if (environ and node.func.attr in ("get", "setdefault")) or (
        isinstance(owner, ast.Name) and owner.id == "os"
        and node.func.attr == "getenv"):
      return _first_string(node)
  elif isinstance(node, ast.Subscript) and isinstance(
      node.value, ast.Attribute) and node.value.attr == "environ" and \
      isinstance(node.slice, ast.Constant):
    return node.slice.value
  return None


def _script_knobs(tree: ast.Module) -> set:
  """The knobs a JAX script reads from ``os.environ`` or ``os.getenv``."""
  return {n for n in map(_environ_read, ast.walk(tree)) if isinstance(n, str)}


def _knobs(tree: ast.Module) -> set:
  """The knobs a port module reads: from ``os.environ`` or ``os.getenv``,
  through an ``env(name, ...)`` helper (``os.environ.get`` or
  ``pipeline.knobs``'s), or as a key of the module's dict passed as
  ``defaults=`` to ``knobs(...)``, whose ``env`` reads it."""
  dicts = {t.id: node.value for node in tree.body
           if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
           for t in node.targets if isinstance(t, ast.Name)}
  out = _script_knobs(tree)
  for node in ast.walk(tree):
    if not isinstance(node, ast.Call):
      continue
    if isinstance(node.func, ast.Name) and node.func.id == "env":
      out.add(_first_string(node))
    elif _call_name(node.func) == "knobs":
      for kw in node.keywords:
        value = kw.value
        if kw.arg == "defaults" and isinstance(value, ast.Name):
          value = dicts.get(value.id)
        if kw.arg == "defaults" and isinstance(value, ast.Dict):
          out |= {k.value for k in value.keys if isinstance(k, ast.Constant)}
  return {n for n in out if isinstance(n, str)}


def script_gaps(script: ast.Module, port_trees) -> list:
  """The flags and knobs that ``script`` reads and none of ``port_trees``
  does."""
  flags = set().union(*map(_flags, port_trees))
  knobs = set().union(*map(_knobs, port_trees))
  return sorted(
      {f for f in _flags(script) if FLAG_RENAMES.get(f, f) not in flags} |
      {k for k in _script_knobs(script) if k not in knobs})


def test_every_script_has_a_port_module():
  scripts = sorted(p.name for p in SCRIPTS.glob("*.py"))
  assert sorted(SCRIPT_MODULES) == scripts
  for dotted in SCRIPT_MODULES.values():
    assert _experiment_file(dotted).exists(), dotted


@pytest.mark.parametrize("script", sorted(
    p.name for p in SCRIPTS.glob("*.py")))
def test_port_module_reads_the_script_flags_and_knobs(script):
  dotted = SCRIPT_MODULES[script]
  trees = [_tree(_experiment_file(m)) for m in _with_imports(dotted)]
  missing = script_gaps(_tree(SCRIPTS / script), trees)
  assert not missing, (
      f"scripts/{script} reads flags or knobs that "
      f"oatomobile_torch.experiments.{dotted} does not: {missing}")


_SCRIPT = """import os
out = os.environ.get("RUN_OUT", "/tmp")
epochs = int(os.getenv("RUN_EPOCHS", "1"))
"""


@pytest.mark.parametrize("port,missing", [
    # Named only: a table's key, a log row's, another object's get.
    ("ROW = {'RUN_OUT': 1, 'RUN_EPOCHS': 2}\nrow.get('RUN_OUT')\n",
     ["RUN_EPOCHS", "RUN_OUT"]),
    # Read through os.environ and an env helper.
    ("import os\nenv = os.environ.get\nenv('RUN_OUT')\n"
     "os.environ['RUN_EPOCHS']\n", []),
    # A defaults dict that knobs() reads, and one that it does not.
    ("D = {'RUN_OUT': 'x', 'RUN_EPOCHS': '2'}\npipeline.knobs(defaults=D)\n",
     []),
    ("D = {'RUN_OUT': 'x', 'RUN_EPOCHS': '2'}\nlog(defaults=D)\n",
     ["RUN_EPOCHS", "RUN_OUT"]),
])
def test_a_knob_counts_only_where_it_is_read(port, missing):
  assert script_gaps(ast.parse(_SCRIPT), [ast.parse(port)]) == missing
