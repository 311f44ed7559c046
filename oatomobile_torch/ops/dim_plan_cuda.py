"""The DIM planner as one hand-written CUDA kernel, its wrapper and its
plain PyTorch version.

``ImitativeModel.plan_from_z`` runs ``num_steps`` Adam steps on the base
sample x [B, T, 2] of a trajectory, from zeros, against the per-scene
negative imitation posterior (the flow's inverse density of y =
decode(x, z), plus the goal likelihood), and returns the decode of the
iterate whose loss was lowest.  The kernel (``csrc/dim_plan.cu``; its
header gives the design, the rounding rules and the bound) runs the whole
plan for 8 scenes a block in one launch: the flow's forward, a
hand-derived backward, Adam in optax's order and the best-iterate
bookkeeping.  It replaces no Pallas kernel: the JAX package's plan is a
``lax.scan`` of ``optax.adam`` that XLA fuses; the port's autograd loop
made ~7,000 small kernels of it.  The kernel repeats that loop's arithmetic
(``models/dim.autograd_plan``: autograd's two backward passes, cuBLAS's
and torch's orders of summation), so on an H100 at 1024 scenes their plans
are equal bit for bit: the plan is chaotic, and the policy's controls turn
on its last bits.

``plan`` dispatches on the device of z: CPU tensors go to the plain
version ``plan_reference``, which writes out the kernel's backward with
tensor operations and no autograd (``loss_and_grad``); CUDA tensors launch
the kernel or raise.  The plan is not differentiable.  ``KERNEL``
(``native/nvcc.py``) builds and loads the kernel and counts its launches.
"""

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from oatomobile_torch.native import nvcc

HIDDEN = 64   # the flow's GRU
HEAD = 32     # the flow's head: HIDDEN -> HEAD -> 2 * DIM
DIM = 2
MAX_HORIZON = 8     # csrc/dim_plan.cu kMaxT
MAX_STEPS = 256     # csrc/dim_plan.cu kMaxSteps
MAX_GOALS = 32      # csrc/dim_plan.cu kMaxGoals

# optax.adam's defaults (models/dim.adam_update).
B1, B2 = 0.9, 0.999
# log(2 pi) as the JAX package rounds it (models/sequence.LOG_2PI).
LOG_2PI = float(np.log(np.float32(2.0 * np.pi)))


class FlowWeights(NamedTuple):
  """The autoregressive flow's parameters, as ``models/sequence`` names
  them: the GRU cell (``w_ih`` [192, 2], ``b_ih`` [192], ``w_hh``
  [192, 64], ``b_hn`` [64]) and the head ``locscale`` (``w0`` [32, 64],
  ``b0`` [32], ``w1`` [4, 32], ``b1`` [4])."""
  w_ih: torch.Tensor
  b_ih: torch.Tensor
  w_hh: torch.Tensor
  b_hn: torch.Tensor
  w0: torch.Tensor
  b0: torch.Tensor
  w1: torch.Tensor
  b1: torch.Tensor


def flow_weights(flow: torch.nn.Module) -> FlowWeights:
  """The weights of an ``AutoregressiveFlow`` (the tensors themselves)."""
  gru, head = flow.gru, flow.locscale
  return FlowWeights(gru.weight_ih, gru.bias_ih, gru.weight_hh, gru.bias_hn,
                     head.dense_0.weight, head.dense_0.bias,
                     head.dense_1.weight, head.dense_1.bias)


def bias_corrections(num_steps: int) -> Tuple[np.ndarray, np.ndarray]:
  """Adam's bias corrections ``1 - b**count`` for count = 1 .. num_steps,
  float32, as ``models/dim.adam_update`` computes them."""
  counts = range(1, num_steps + 1)
  c1 = [1 - np.float32(B1)**np.float32(n) for n in counts]
  c2 = [1 - np.float32(B2)**np.float32(n) for n in counts]
  return np.asarray(c1, np.float32), np.asarray(c2, np.float32)


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
  """Sets the C entry points' argument types on ``lib`` (the kernel's
  library, or another build of its source); returns it."""
  ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                        ctypes.c_float)
  lib.dim_plan_launch.argtypes = [
      ptr, ptr, i32, i64, i64, i64,            # z, goal, K, goal strides
      ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,  # the flow's weights
      ptr, f32, ptr, f32, f32,                 # lr, epsilon: 1 / it, log
      f32, f32, f32,                           # the loss's constants
      ptr, ptr,                                # 1 / bias corrections
      ptr, ptr, i32, i32, i32, ptr]            # out, best, B, T, steps
  lib.dim_plan_launch.restype = i32
  lib.dim_plan_configure.argtypes = []
  lib.dim_plan_configure.restype = i32
  lib.dim_plan_smem_bytes.argtypes = [i32]
  lib.dim_plan_smem_bytes.restype = i32
  return lib


# IEEE float32: no fast-math, and no contraction of a product and a sum
# into one FMA outside the dot products (which call fmaf themselves).
KERNEL = nvcc.Kernel("dim_plan", "dim_plan.cu",
                     (*nvcc.ARCH, "-fmad=false", *nvcc.SHARED), declare)


@functools.lru_cache(maxsize=None)
def _configure(device: torch.device) -> None:
  """Lets the kernel take its shared memory on ``device`` (once)."""
  with torch.cuda.device(device):
    err = KERNEL.library().dim_plan_configure()
  if err != 0:
    raise RuntimeError("dim_plan: cudaFuncSetAttribute failed: CUDA error "
                       "{}".format(err))


@functools.lru_cache(maxsize=None)
def _host_tables(num_steps: int):
  """The bias corrections' float32 reciprocals, which torch multiplies by
  where a kernel divides by a host number, as ctypes arrays (kept alive
  by the cache)."""
  one = np.float32(1.0)
  return tuple((ctypes.c_float * max(num_steps, 1))(*(one / c))
               for c in bias_corrections(num_steps))


def _check_scalar(name: str, v, device) -> None:
  if isinstance(v, torch.Tensor):
    nvcc.check_input(name, v, (), device, "z")


def _check_inputs(weights: FlowWeights, z, goal, horizon: int, lr,
                  epsilon) -> None:
  device = z.device
  B = z.shape[0] if z.dim() == 2 else -1
  nvcc.check_input("z", z, (None, HIDDEN), device, "z")
  if goal is not None:
    nvcc.check_input("goal", goal, (B, None, DIM), device, "z")
  shapes = dict(w_ih=(3 * HIDDEN, DIM), b_ih=(3 * HIDDEN,),
                w_hh=(3 * HIDDEN, HIDDEN), b_hn=(HIDDEN,), w0=(HEAD, HIDDEN),
                b0=(HEAD,), w1=(2 * DIM, HEAD), b1=(2 * DIM,))
  for name, x in weights._asdict().items():
    nvcc.check_input(name, x, shapes[name], device, "z")
  _check_scalar("lr", lr, device)
  _check_scalar("epsilon", epsilon, device)
  if horizon < 1:
    raise ValueError("the horizon must be at least 1, got {}".format(horizon))


# -- The plain version ---------------------------------------------------------


def _goal_term(y_last: torch.Tensor, goal: torch.Tensor, epsilon):
  """(goal log-likelihood [B], its loss's gradient -d gl / d y_last [B, D])
  of ``models/dim.goal_likelihood``, the forward in its operations."""
  _, K, D = goal.shape
  diff = y_last[:, None, :] - goal  # [B, K, D]
  log_epsilon = (torch.log(epsilon) if isinstance(epsilon, torch.Tensor)
                 else float(np.log(np.float32(epsilon))))
  u = diff / epsilon
  comp = -0.5 * (u**2).sum(-1) - D * log_epsilon - 0.5 * D * LOG_2PI
  lse = torch.logsumexp(comp, dim=-1)
  gl = lse - float(np.log(np.float32(K)))
  # -d gl / d comp = -softmax; d comp / d u = -u; d u / d y = 1 / epsilon.
  half_w = 0.5 * torch.exp(comp - lse[:, None])
  grad = ((half_w[..., None] * (2 * u)) / epsilon).sum(1)
  return gl, grad


def loss_and_grad(weights: FlowWeights, x: torch.Tensor, z: torch.Tensor,
                  goal: Optional[torch.Tensor] = None, epsilon=1.0):
  """The plan's per-scene loss at x [B, T, D] and its gradient, by the
  kernel's hand-derived backward (autograd's two passes, its terms added in
  autograd's order; the sums in this device's own).

  The loss is ``-(imitation_prior(decode(x, z)) + goal_likelihood)`` in
  the operations of ``models/sequence`` and ``models/dim`` (so equal to
  their forward bit for bit on the CPU): decode's and the inverse's GRU
  cell, which see the same inputs, run once a step.

  Returns:
    (loss [B], d loss / d x [B, T, D], y = decode(x, z) [B, T, D]).
  """
  w = weights
  B, T, D = x.shape
  H = w.w_hh.shape[1]
  bias_hh = F.pad(w.b_hn, (2 * H, 0))
  y_prev = torch.zeros(B, D, dtype=x.dtype, device=x.device)
  h = z
  saved, ys, xps, log_scales = [], [], [], []
  for t in range(T):
    # torch.gru_cell's CPU operations, keeping the gates for the backward.
    gi = F.linear(y_prev, w.w_ih, w.b_ih).chunk(3, 1)
    gh = F.linear(h, w.w_hh, bias_hh).chunk(3, 1)
    r = (gh[0] + gi[0]).sigmoid()
    u = (gh[1] + gi[1]).sigmoid()
    n = (gi[2] + gh[2] * r).tanh()
    h_new = (h - n) * u + n
    a = F.relu(F.linear(h_new, w.w0, w.b0))
    o = F.linear(a, w.w1, w.b1)
    raw = o[:, D:]
    scale = F.softplus(raw) + 1e-3
    base = y_prev + o[:, :D]
    y = base + scale * x[:, t]
    xp = (y - base) / scale  # the inverse's x', from y
    saved.append((h, r, u, n, gh[2], a, raw, scale, xp))
    ys.append(y)
    xps.append(xp)
    log_scales.append(torch.log(scale))
    y_prev, h = y, h_new
  y = torch.stack(ys, dim=-2)
  xprime = torch.stack(xps, dim=-2)
  logabsdet = torch.stack(log_scales, dim=-2).sum(dim=(-2, -1))
  log_prob = -0.5 * (xprime * xprime).sum(dim=(-2, -1)) - 0.5 * T * D * LOG_2PI
  posterior = log_prob - logabsdet
  if goal is not None:
    gl, y_bar = _goal_term(y[:, -1], goal, epsilon)
    posterior = posterior + gl
  else:
    y_bar = torch.zeros(B, D, dtype=x.dtype, device=x.device)

  # Autograd's two passes: back through the inverse's graph to d loss / d y
  # (the goal's term first), then through decode's to d loss / d x, each
  # adding its terms in the order autograd's engine adds them.  Neither
  # reaches the cell or the head at t = 0 (their inputs take no gradient),
  # nor h_0 from t = 1.
  def cell_backward(t, o_bar, h_bar):
    """The head's and the cell's backward at step t >= 1 (torch's fused
    cell's gate algebra): (h_{t-1}'s adjoint or None, y_{t-1}'s share)."""
    h_prev, r, u, n, hn, a, _, _, _ = saved[t]
    head = torch.where(a > 0, o_bar @ w.w1, 0.0) @ w.w0
    h_bar = head if h_bar is None else h_bar + head
    one_u = 1 - u
    g_u = h_bar * (h_prev - n) * one_u * u
    g_n = h_bar * one_u * (1 - n * n)
    g_r = g_n * hn * (1 - r) * r
    h_prev_bar = (h_bar * u + torch.cat([g_r, g_u, g_n * r], dim=1) @ w.w_hh
                  if t > 1 else None)
    return h_prev_bar, torch.cat([g_r, g_u, g_n], dim=1) @ w.w_ih

  def softplus_backward(grad, raw):  # torch's threshold 20
    ez = torch.exp(raw)
    return torch.where(raw > 20.0, grad, grad * ez / (ez + 1))

  y_inv, h_bar, view = [None] * T, None, None
  for t in reversed(range(T)):
    _, _, _, _, _, _, raw, scale, xp = saved[t]
    q = xp / scale  # x' = (y_t - (y_{t-1} + dloc)) / scale; d loss / d x' = x'
    view = q if t == T - 1 else view + q
    y_inv[t] = y_bar + view if t == T - 1 else view
    if t > 0:
      scale_bar = 1.0 / scale + (-xp) * q
      o_bar = torch.cat([-q, softplus_backward(scale_bar, raw)], dim=1)
      h_bar, share = cell_backward(t, o_bar, h_bar)
      view = -q + share
  grads, h_bar, y_tot = [None] * T, None, None
  for t in reversed(range(T)):
    _, _, _, _, _, _, raw, scale, _ = saved[t]
    y_t = y_inv[t] if t == T - 1 else y_tot  # y_t = base + scale * x_t
    grads[t] = y_t * scale
    if t > 0:
      o_bar = torch.cat([y_t, softplus_backward(y_t * x[:, t], raw)], dim=1)
      h_bar, share = cell_backward(t, o_bar, h_bar)
      y_tot = (y_inv[t - 1] + y_t) + share
  return -posterior, torch.stack(grads, dim=-2), y


def plan_reference(weights: FlowWeights, z: torch.Tensor,
                   goal: Optional[torch.Tensor], *, num_steps: int, lr,
                   epsilon, horizon: int):
  """The kernel's function in plain PyTorch: ``num_steps`` Adam steps
  (``models/dim.adam_update``) from x = 0 on ``loss_and_grad``, the best
  iterate by the strict rule of ``best_adam_iterate`` (+inf start).

  Returns:
    (the best iterate's decode [B, horizon, 2], its step [B] int32).
  """
  from oatomobile_torch.models.dim import adam_update  # pylint: disable=import-outside-toplevel
  _check_inputs(weights, z, goal, horizon, lr, epsilon)
  with torch.no_grad():
    shape = (z.shape[0], horizon, weights.w_ih.shape[1])
    x = torch.zeros(shape, dtype=torch.float32, device=z.device)
    mu, nu = torch.zeros_like(x), torch.zeros_like(x)
    loss_best = torch.full(shape[:1], float("inf"), device=z.device)
    best = torch.zeros(shape[:1], dtype=torch.int32, device=z.device)
    y_best = None
    for step in range(max(num_steps, 1)):
      loss, g, y = loss_and_grad(weights, x, z, goal, epsilon)
      if y_best is None:
        y_best = y  # the first iterate, x = 0, until one beats +inf
      better = loss < loss_best
      y_best = torch.where(better[:, None, None], y, y_best)
      best = torch.where(better, step, best).to(torch.int32)
      loss_best = torch.where(better, loss, loss_best)
      if step == num_steps:  # no steps: decode(0, z) only
        break
      update, mu, nu = adam_update(g, mu, nu, step + 1, lr)
      x = x + update
  return y_best, best


# -- The wrapper ----------------------------------------------------------------


def launch(lib: ctypes.CDLL, weights: FlowWeights, z: torch.Tensor,
           goal: Optional[torch.Tensor], *, num_steps: int, lr, epsilon,
           horizon: int, stream):
  """One call of ``lib``'s ``dim_plan_launch`` on inputs that ``plan`` has
  checked, on ``stream``: the outputs allocated, the numbers packed as the
  kernel takes them (a number's float32 reciprocal where torch multiplies
  by one, float32 logs).  Returns (plan, best_step)."""
  B = z.shape[0]
  out = torch.empty((B, horizon, DIM), dtype=torch.float32, device=z.device)
  best = torch.empty((B,), dtype=torch.int32, device=z.device)
  r1, r2 = _host_tables(num_steps)
  lr_ptr, lr_value = ((lr.data_ptr(), 0.0) if isinstance(lr, torch.Tensor)
                      else (None, float(lr)))
  if isinstance(epsilon, torch.Tensor):
    eps_ptr, inv_eps, log_eps = epsilon.data_ptr(), 0.0, 0.0
  else:
    eps_ptr = None
    inv_eps = float(np.float32(1.0) / np.float32(epsilon))
    log_eps = float(np.log(np.float32(epsilon)))
  if goal is None:
    goal_ptr, K, strides = None, 0, (0, 0, 0)
  else:
    goal_ptr, K, strides = goal.data_ptr(), goal.shape[1], goal.stride()
  err = lib.dim_plan_launch(
      z.data_ptr(), goal_ptr, K, *strides,
      *(x.data_ptr() for x in weights), lr_ptr, lr_value, eps_ptr, inv_eps,
      log_eps, 0.5 * horizon * DIM * LOG_2PI, 0.5 * DIM * LOG_2PI,
      float(np.log(np.float32(max(K, 1)))), r1, r2, out.data_ptr(),
      best.data_ptr(), B, horizon, num_steps, stream)
  KERNEL.check(err)
  return out, best



def plan(weights: FlowWeights, z: torch.Tensor,
         goal: Optional[torch.Tensor] = None, *, num_steps: int, lr,
         epsilon, horizon: int):
  """The DIM plan from the context encoding z [B, 64].

  Args:
    weights: the flow's (``flow_weights``), float32, contiguous.
    z: [B, 64] float32, contiguous.
    goal: [B, K, 2] float32 goals (any strides; K 1 .. 32 on CUDA), or
      None.
    num_steps: Adam steps, 0 .. 256 on CUDA.
    lr, epsilon: numbers, or 0-d float32 tensors on z's device.
    horizon: T, 1 .. 8 on CUDA.

  Returns:
    (plan [B, T, 2] float32, best_step [B] int32: the chosen iterate's
    step, counted from 0).  On CUDA tensors the kernel computes them, on
    CPU tensors the plain version does.
  """
  if z.device.type == "cpu":
    return plan_reference(weights, z, goal, num_steps=num_steps, lr=lr,
                          epsilon=epsilon, horizon=horizon)
  if z.device.type != "cuda":
    raise ValueError("the DIM plan runs on CUDA or CPU tensors, got "
                     "{}".format(z.device))
  _check_inputs(weights, z, goal, horizon, lr, epsilon)
  if not 1 <= horizon <= MAX_HORIZON:
    raise ValueError("the kernel plans 1 to {} steps ahead, got {}".format(
        MAX_HORIZON, horizon))
  if not 0 <= num_steps <= MAX_STEPS:
    raise ValueError("the kernel takes 0 to {} Adam steps, got {}".format(
        MAX_STEPS, num_steps))
  if goal is not None and not 1 <= goal.shape[1] <= MAX_GOALS:
    raise ValueError("the kernel takes 1 to {} goals a scene, got {}".format(
        MAX_GOALS, goal.shape[1]))
  nvcc.check_contiguous((("z", z), *weights._asdict().items()))
  B = z.shape[0]
  if B == 0:
    return (torch.empty((0, horizon, DIM), device=z.device),
            torch.empty((0,), dtype=torch.int32, device=z.device))
  _configure(z.device)
  out, best = launch(KERNEL.library(), weights, z, goal,
                     num_steps=num_steps, lr=lr, epsilon=epsilon,
                     horizon=horizon,
                     stream=torch.cuda.current_stream(z.device).cuda_stream)
  KERNEL.launches += 1
  return out, best
