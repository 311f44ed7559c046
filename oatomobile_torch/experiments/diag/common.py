"""The diagnostics' shared forensics rollout, on static buffers.

Each of the JAX package's ``scripts/diag_*.py`` jits a ``lax.scan`` whose
body is the same: the policy over the batch, the actions of scenes whose
episode ended frozen to a full brake ``[0, 0, 1]``, ``world_step``, then
per-step forensics folded into a dict of per-scene accumulators.  Here
that body is written once: :func:`run` keeps the scene state and the
accumulators in static buffers and takes one ``graphs.CapturedStep`` a
step (a CUDA-graph replay on a card, the same step eagerly on the CPU),
and :func:`run_eager` is the plain loop it is held against.

``accumulate(m, old_state, new_state, active) -> m`` reads the
accumulators ``m`` (a dict of tensors, nested dicts allowed), the state
before the policy's call, the state after the world step and the
``active`` flags before the step (``m["active"]``, or None), and returns
the next accumulators as new tensors of the same shapes and dtypes.  It
runs inside the capture: it branches on shapes only, never on a tensor's
value, and makes no host tensors (``sim.util.constant`` makes its
constants once, in the warm-up).
"""

import argparse
from typing import Callable, Dict, Tuple

import torch

from oatomobile_torch import device as device_lib
from oatomobile_torch import graphs
from oatomobile_torch.benchmarks.batched_eval import town_group_scenes
from oatomobile_torch.sim import autopilot_policy, world_step
from oatomobile_torch.sim.types import (SceneState, clone_state, copy_state_,
                                        map_state)
from oatomobile_torch.sim.util import constant, norm

# A hero within this many metres of its destination has arrived.
ARRIVAL_M = 7.5
# A hero (or NPC) slower than this is stopped.
STOPPED_MPS = 0.3
# The scripts count a hero held at a yield this many steps as asserting.
ASSERT_STEPS = 120


def autopilot(params, states):
  """The autopilot expert over the batch, without noise."""
  return autopilot_policy(params, states)


def scenes(town_name: str, configs, episodes: int = 1, seed: int = 0,
           device="cuda"):
  """(params, states): scene ``e * T + i`` is episode ``e`` of task
  ``configs[i]`` at its origin, destination and traffic, as the JAX
  scripts build them (route capacity 2048)."""
  return town_group_scenes(town_name, configs, episodes, seed,
                           device_lib.resolve(device))


def arrived(state: SceneState) -> torch.Tensor:
  """[B] the hero within ARRIVAL_M of its destination."""
  return norm(state.hero_xy - state.destination_xy) < ARRIVAL_M


def _tree_map(fn, tree):
  if isinstance(tree, dict):
    return {k: _tree_map(fn, v) for k, v in tree.items()}
  return fn(tree)


def _copy_into(dst, src) -> None:
  for k, v in dst.items():
    if isinstance(v, dict):
      _copy_into(v, src[k])
    elif v is not src[k]:
      v.copy_(src[k])


def _step(params, state, m, policy, accumulate, freeze: bool):
  """One step: (accumulators, state) after it, as new tensors."""
  active = m.get("active")
  actions, live = policy(params, state)
  if freeze:
    frozen = constant((0.0, 0.0, 1.0), actions.device)
    actions = torch.where(active[:, None], actions, frozen)
  new_state = world_step(params, live, actions)
  return accumulate(m, state, new_state, active), new_state


def host(m):
  """The accumulators as numpy arrays (nested dicts kept)."""
  return _tree_map(lambda t: t.detach().cpu().numpy(), m)


def run(params, states: SceneState, policy: Callable, accumulate: Callable,
        m0: Dict, num_steps: int, device="cuda", *,
        freeze: bool = True) -> Tuple[Dict, SceneState]:
  """``num_steps`` forensics steps from ``states`` with the accumulators
  ``m0`` (neither is changed): each step the policy, the actions of
  inactive scenes frozen (with ``freeze``; ``m0`` then holds ``active``),
  ``world_step`` and ``accumulate`` (module docstring), on static buffers
  through one ``graphs.CapturedStep``.  Returns (accumulators, final
  state), host copies."""
  device = device_lib.resolve(device)
  state = clone_state(states.to(device))
  m = _tree_map(lambda t: t.to(device).clone(), m0)

  def step():
    new_m, new_state = _step(params, state, m, policy, accumulate, freeze)
    _copy_into(m, new_m)
    copy_state_(state, new_state)

  runner = graphs.CapturedStep(step, device, pool=graphs.new_pool(device))
  with torch.no_grad():
    for _ in range(num_steps):
      runner()
  return (_tree_map(lambda t: t.to("cpu", copy=True), m),
          map_state(lambda t: t.to("cpu", copy=True), state))


def run_eager(params, states: SceneState, policy: Callable,
              accumulate: Callable, m0: Dict, num_steps: int, *,
              freeze: bool = True) -> Tuple[Dict, SceneState]:
  """:func:`run` as a plain loop that launches every op from the host:
  the yardstick the tests and ``chip_smoke.py`` hold the captured step
  against.  Runs where ``states`` lie."""
  m, state = m0, states
  with torch.no_grad():
    for _ in range(num_steps):
      m, state = _step(params, state, m, policy, accumulate, freeze)
  return (_tree_map(lambda t: t.to("cpu", copy=True), m),
          map_state(lambda t: t.to("cpu", copy=True), state))


def parser(description: str) -> argparse.ArgumentParser:
  """The JAX script's flags go on this parser; ``--cpu`` runs on the CPU
  (default: the CUDA card)."""
  p = argparse.ArgumentParser(description=description)
  p.add_argument("--cpu", action="store_true",
                 help="run on the CPU (default: the CUDA card)")
  return p


def device_of(args) -> str:
  return "cpu" if args.cpu else "cuda"


def carnovel_ids(family: str):
  """The sorted CARNOVEL task ids that start with ``family``."""
  from oatomobile_torch.benchmarks.carnovel.benchmark import _TASKS  # pylint: disable=import-outside-toplevel
  return sorted(t for t in _TASKS if t.startswith(family))


def carnovel_scenes(ids, episodes: int, seed: int = 7, device="cuda"):
  """(town, params, states) of CARNOVEL tasks ``ids`` x ``episodes``, all
  in the first task's town, as the JAX scripts build them."""
  from oatomobile_torch.benchmarks.carnovel.benchmark import _TASKS  # pylint: disable=import-outside-toplevel
  configs = [_TASKS[t] for t in ids]
  town = configs[0]["town"]
  params, states = scenes(town, configs, episodes, seed, device)
  return town, params, states


def require_matplotlib(name: str) -> None:
  """Raises unless matplotlib is importable: the drawing diagnostics'
  ``main`` draws on the host, and the card's machine has no matplotlib."""
  import importlib.util  # pylint: disable=import-outside-toplevel
  if importlib.util.find_spec("matplotlib") is None:
    raise RuntimeError(
        "{} draws with matplotlib, which is not installed here; call "
        "run() for the rollout's data without drawing".format(name))
