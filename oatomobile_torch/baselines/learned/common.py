"""Shared observation preparation for the single-scene learned agents: a
copy of the JAX package's ``baselines/learned/common.py`` (batchify,
goal -> 2D, the command from the goal's geometry, the 4 -> 40 plan
interpolation with an appended z column), plus ``act_inputs``, what a
model reads of an observation, and ``CapturedAct``, the agents'
counterpart of the JAX agents' jitted plan.
"""

from typing import Callable, Dict, Mapping, Sequence

import numpy as np
import torch

from oatomobile_torch import graphs

PLAYER_FUTURE_LENGTH = 40


def prepare_observation(
    observation: Mapping[str, np.ndarray]) -> Mapping[str, np.ndarray]:
  """Batchifies raw observations; goal trimmed to 2D; images stay NHWC
  (the models' ``transform`` makes them NCHW)."""
  out = {}
  for attr, value in observation.items():
    value = np.asarray(value) if isinstance(value, np.ndarray) else \
        np.atleast_1d(np.asarray(value, dtype=np.float32))
    out[attr] = value[None, ...].astype(np.float32)
  if "bird_view_camera_cityscapes" in out:
    out["overhead_features"] = out["bird_view_camera_cityscapes"]
  if "goal" in out:
    out["goal"] = out["goal"][..., :2]
  return out


def mode_from_goal(goal: np.ndarray, signed: bool = True) -> float:
  """Command label {0 FORWARD, 1 STOP, 2 LEFT, 3 RIGHT} from the goal
  endpoint geometry.

  The reference has two conflicting rules (datasets/carla.py:150-157 uses
  theta <= -15 for RIGHT — unreachable since arccos >= 0; cil/agent.py:67-74
  uses theta <= 15 — which also swallows FORWARD).  The ``signed`` variant
  resolves the bug with a signed angle; pass signed=False for the dataset
  rule.
  """
  x_t, y_t = goal[0, -1, :2]
  norm = float(np.linalg.norm([x_t, y_t]))
  if norm < 3:
    return 1.0  # STOP
  if signed:
    theta = float(np.degrees(np.arctan2(y_t, x_t)))
    if theta > 15:
      return 3.0  # RIGHT (+y is the right-hand side)
    if theta < -15:
      return 2.0  # LEFT
    return 0.0
  theta = float(np.degrees(np.arccos(x_t / (norm + 1e-3))))
  if theta > 15:
    return 2.0
  if theta <= -15:
    return 3.0
  return 0.0


def interpolate_plan(plan: np.ndarray,
                     length: int = PLAYER_FUTURE_LENGTH) -> np.ndarray:
  """Linear 1-D interpolation of a [T, 2] plan to [length-step, 3]
  (x, y, z=0), matching the agents' scipy.interp1d usage
  (e.g. dim/agent.py:75-84)."""
  T = plan.shape[0]
  increments = length // T
  time_index = np.arange(0, length, increments)[:T]
  dense_t = np.arange(0, time_index[-1])
  xy = np.stack(
      [np.interp(dense_t, time_index, plan[:, d]) for d in range(2)],
      axis=-1)
  z = np.zeros((xy.shape[0], 1))
  return np.concatenate([xy, z], axis=-1)


# What the learned models read of a prepared observation.
MODEL_KEYS = ("lidar", "visual_features", "velocity", "is_at_traffic_light",
              "traffic_light_state", "goal", "mode")


def model_context(sample: Mapping[str, torch.Tensor],
                  keys: Sequence[str]) -> dict:
  """The model's context from a transformed sample: scalars that arrive
  as [1] become [B, 1], as the models expect."""
  context = {k: sample[k] for k in keys if k in sample}
  for key in ("is_at_traffic_light", "traffic_light_state"):
    if key in context and context[key].dim() == 1:
      context[key] = context[key][:, None]
  return context


_ALIGN = 16  # float32 elements: 64 bytes


class CapturedAct:
  """An agent's act on static inputs, as the JAX agents jit theirs.

  ``fn(inputs, **static)`` reads ``inputs``, a dict of float32 tensors of
  fixed shape on ``device`` (the observation's model keys and the traced
  scalars, such as ``lr`` and ``epsilon`` as 0-d tensors), and returns the
  plan [1, T, 2].  Each call copies the new inputs into those buffers
  (one host-to-device copy, through a pinned host buffer on a card) and
  runs ``fn`` as a ``graphs.CapturedStep``: one step per value of the
  ``static`` keyword arguments (``num_steps``), as ``jax.jit``'s
  ``static_argnames`` compile one program per value, in a graph pool this
  object owns (freed with it).  The inputs' names and shapes are fixed by
  the first call: another shape raises, nothing captures again.  Returns
  the plan [T, 2] as a host copy.

  ``fn`` must not hold the agent (a plain function over the models):
  the steps would keep it, and their graphs, alive in a reference cycle.
  """

  def __init__(self, fn: Callable[..., torch.Tensor], device) -> None:
    self._fn = fn
    self._device = torch.device(device)
    self._pool = graphs.new_pool(self._device)
    self._shapes = None
    self._host = None       # name -> view of the flat host buffer
    self._host_flat = None
    self._flat = None       # the flat buffer on ``device``
    self._inputs = None     # name -> view of ``_flat``
    self._steps = {}

  @property
  def steps(self) -> Dict[tuple, "graphs.CapturedStep"]:
    """The captured steps by their static arguments."""
    return self._steps

  def _allocate(self, inputs: Mapping[str, np.ndarray]) -> None:
    self._shapes = {k: np.shape(v) for k, v in inputs.items()}
    sizes = [int(np.prod(s)) for s in self._shapes.values()]
    # Each input starts on a 64-byte boundary, as a tensor of its own
    # would (the kernels' vectorised loads need the alignment).
    starts = np.cumsum([0] + [-(-n // _ALIGN) * _ALIGN for n in sizes])
    cuda = self._device.type == "cuda"
    self._host_flat = torch.zeros(int(starts[-1]), dtype=torch.float32,
                                  pin_memory=cuda)
    self._flat = torch.zeros(int(starts[-1]), dtype=torch.float32,
                             device=self._device)
    host = self._host_flat.numpy()
    self._host, self._inputs = {}, {}
    for (name, shape), size, start in zip(self._shapes.items(), sizes,
                                          starts):
      self._host[name] = host[start:start + size].reshape(shape)
      self._inputs[name] = self._flat[start:start + size].view(shape)

  def _check(self, inputs: Mapping[str, np.ndarray]) -> None:
    shapes = {k: np.shape(v) for k, v in inputs.items()}
    if shapes != self._shapes:
      changed = sorted(k for k in set(shapes) | set(self._shapes)
                       if shapes.get(k) != self._shapes.get(k))
      raise ValueError(
          "the captured act was built for inputs {}; {} arrived as {}".format(
              self._shapes, ", ".join(changed),
              {k: shapes.get(k) for k in changed}))

  def __call__(self, inputs: Mapping[str, np.ndarray],
               **static) -> np.ndarray:
    if self._shapes is None:
      self._allocate(inputs)
    self._check(inputs)
    for name, view in self._host.items():
      np.copyto(view, inputs[name], casting="same_kind")
    self._flat.copy_(self._host_flat, non_blocking=True)
    key = tuple(sorted(static.items()))
    step = self._steps.get(key)
    if step is None:
      fn, buffers = self._fn, self._inputs
      step = graphs.CapturedStep(lambda: fn(buffers, **static), self._device,
                                 pool=self._pool)
      self._steps[key] = step
    # A host copy: the step's output is the graph's, which the next replay
    # overwrites.
    return step()[0].to("cpu", copy=True).numpy()


def act_inputs(obs: Mapping[str, np.ndarray],
               **scalars: float) -> Dict[str, np.ndarray]:
  """The inputs of a ``CapturedAct`` from a prepared observation: its
  model keys and the traced ``scalars`` as float32."""
  out = {k: np.asarray(v, dtype=np.float32) for k, v in obs.items()
         if k in MODEL_KEYS}
  out.update({k: np.float32(v) for k, v in scalars.items()})
  return out
