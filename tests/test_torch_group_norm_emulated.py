"""The GroupNorm kernel's CUDA source, built by g++ for the CPU and run with
each CUDA thread a host thread (``tests/cuda_emulation/cuda_runtime.h``),
against a numpy restatement of PyTorch's CUDA GroupNorm
(``aten/src/ATen/native/cuda/group_norm_kernel.cu``: the moments kernel's
Welford order and block reduce, the fused scale and bias, the apply, the
clamp of ``F.relu6`` and the residual add).

The kernel cannot run here; this holds its indexing, its two thread
regimes (one warp a group under 512 floats, 512 threads over; rows past
20,480 floats read twice from memory), its
barriers and shuffles, its ragged rows and blocks and every epilogue on
the CPU, through the wrapper's packing of the arguments
(``group_norm_cuda.launch``).  Both sides round as IEEE float32 with the
same fused multiply-adds, and the host's 1 / sqrtf stands in for CUDA's
rsqrtf on both, so they agree bit for bit.  Skips without g++.
"""

import numpy as np
import pytest
import torch

from oatomobile_torch.ops import group_norm_cuda
from torch_port_helpers import emulated_library

torch.set_num_threads(1)

EPS = 1e-6
WARP = 32


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
  """The kernel's library built from ``csrc/group_norm.cu`` for the host."""
  return emulated_library(
      group_norm_cuda.KERNEL, tmp_path_factory.mktemp("group_norm_emulated"),
      launches=3,
      prelude="inline float rsqrtf(float x) { return 1.0f / sqrtf(x); }\n"
      "namespace { alignas(16) float4 smem4[1 << 10]; }\n"
      "std::size_t emulated_smem_bytes() { return sizeof(smem4); }\n")


# -- PyTorch's CUDA GroupNorm, restated in numpy --------------------------------


def fma32(a, b, c):
  """a * b + c of float32 arrays rounded once to float32, as a fused
  multiply-add: the product is exact in float64, the sum's error exact by
  two-sum, and the error breaks the tie where the float64 sum falls on a
  midpoint of two float32 neighbours."""
  a, b, c = (np.asarray(v, np.float32).astype(np.float64) for v in (a, b, c))
  p = a * b
  s = p + c
  bb = s - p
  err = (p - (s - bb)) + (c - bb)
  r = s.astype(np.float32)
  lo = np.where(r.astype(np.float64) <= s, r,
                np.nextafter(r, np.float32(-np.inf)))
  hi = np.nextafter(lo, np.float32(np.inf))
  tie = (s == (lo.astype(np.float64) + hi.astype(np.float64)) / 2) & (err != 0)
  return np.where(tie, np.where(err > 0, hi, lo), r).astype(np.float32)


def combine(a, b):
  """WelfordOps::combine of (mean, m2, nf) arrays, element by element."""
  with np.errstate(divide="ignore", invalid="ignore"):
    delta = b[0] - a[0]
    count = a[2] + b[2]
    nb_over_n = b[2] / count
    mean = fma32(delta, nb_over_n, a[0])
    m2 = fma32(delta * delta * a[2], nb_over_n, a[1] + b[1])
  return tuple(np.where(a[2] == 0, bv, np.where(b[2] == 0, av, cv))
               for av, bv, cv in zip(a, b, (mean, m2, count)))


def warp_reduce(state):
  """The shuffle-down tree of cuda_utils::WarpReduce over the last axis
  (32 lanes): a lane past the warp's end reads its own value."""
  lanes = np.arange(WARP)
  for offset in (16, 8, 4, 2, 1):
    src = np.where(lanes + offset < WARP, lanes + offset, lanes)
    state = combine(state, tuple(s[..., src] for s in state))
  return state


def row_moments(row: np.ndarray):
  """RowwiseMomentsCUDAKernel on one row: (mean, rstd) as float32."""
  n = row.size
  threads = WARP if n < 512 else 512
  per = -(-n // threads)
  v = np.zeros(per * threads, np.float32)
  v[:n] = row
  v = v.reshape(per, threads)
  zero = np.zeros(threads, np.float32)
  mean, m2, nf = zero, zero, zero
  for i in range(per):
    valid = np.arange(threads) + i * threads < n
    count = np.float32(i + 1)
    delta = v[i] - mean
    new_mean = mean + delta / count
    new_m2 = fma32(delta, v[i] - new_mean, m2)
    mean, m2, nf = (np.where(valid, new, old) for new, old in (
        (new_mean, mean), (new_m2, m2), (count, nf)))
  state = warp_reduce(tuple(s.reshape(-1, WARP) for s in (mean, m2, nf)))
  state = tuple(s[:, 0] for s in state)  # each warp's lane 0
  if threads > WARP:  # BlockReduce: warp 0 over the warps' results
    state = warp_reduce(tuple(np.concatenate(
        [s, np.zeros(WARP - s.size, np.float32)]) for s in state))
    state = tuple(s[..., 0] for s in state)
  mean, m2, nf = (np.float32(s.reshape(-1)[0]) for s in state)
  var = m2 / nf
  return mean, np.float32(1) / np.sqrt(var + np.float32(EPS))


def torch_cuda_group_norm(x, gamma, beta, relu6, residual):
  """F.group_norm(x, C / 8, gamma, beta, EPS) as PyTorch's CUDA kernels
  compute it, then F.relu6 or residual + y; numpy float32 in and out."""
  n, c, h, w = x.shape
  hw = h * w
  groups = c // group_norm_cuda.GROUP
  rows = x.reshape(n * groups, -1)
  y = np.empty_like(rows)
  means, rstds = np.empty(n * groups, np.float32), np.empty(
      n * groups, np.float32)
  for r, row in enumerate(rows):
    mean, rstd = row_moments(row)
    means[r], rstds[r] = mean, rstd
    ch = (r % groups) * group_norm_cuda.GROUP + np.arange(row.size) // hw
    if hw == 1:  # GroupNorm1dForward
      y[r] = fma32((row - mean) * rstd, gamma[ch], beta[ch])
    else:  # ComputeFusedParamsCUDAKernel (its bias uncontracted), the apply
      scale = rstd * gamma[ch]
      y[r] = fma32(scale, row, -scale * mean + beta[ch])
  y = y.reshape(x.shape)
  if relu6:
    y = np.where(np.isnan(y), y, np.minimum(np.maximum(y, 0), 6))
  if residual is not None:
    y = residual + y
  return y, means, rstds


# -- The tests --------------------------------------------------------------------


def inputs(shape, seed: int):
  """x with per-channel offsets and spreads (so that the mean is far from
  0 in some groups), gamma and beta, and a residual."""
  rng = np.random.default_rng(seed)
  c = shape[1]
  offset = rng.normal(0, 4, (1, c, 1, 1))
  spread = rng.uniform(0.1, 3, (1, c, 1, 1))
  x = (rng.normal(size=shape) * spread + offset).astype(np.float32)
  gamma = rng.normal(1, 0.5, c).astype(np.float32)
  beta = rng.normal(0, 1, c).astype(np.float32)
  residual = rng.normal(size=shape).astype(np.float32)
  return x, gamma, beta, residual


@pytest.mark.parametrize("shape,epilogue", [
    ((3, 16, 1, 1), "relu6"),      # HW = 1: GroupNorm1dForward's apply
    ((2, 24, 7, 7), "relu6"),      # 392 floats: one warp, 12 or 13 a lane
    ((3, 24, 4, 4), "residual"),   # 128 floats; 9 rows, a ragged block
    ((2, 16, 7, 7), "none"),
    ((2, 16, 5, 15), "none"),      # 600 floats: 512 threads, 1 or 2 each
    ((1, 16, 5, 15), "relu6"),
    ((2, 8, 5, 15), "residual"),
    ((3, 16, 5, 15), "residual"),  # 6 rows: 4 a team, a ragged team
    ((1, 16, 25, 25), "residual"),  # 5,000 floats: 9 or 10 a thread
    ((1, 8, 50, 50), "relu6"),     # 20,000 floats: 39 or 40 a thread
    ((1, 8, 51, 51), "relu6"),     # 20,808 floats: read twice, 40 or 41
    ((2, 16, 52, 53), "residual"),  # 22,048 floats a row, 4 rows
])
def test_emulated_kernel_matches_torch_cuda_order(emulated, shape, epilogue):
  x, gamma, beta, residual = inputs(shape, sum(shape))
  res = residual if epilogue == "residual" else None
  want, want_mean, want_rstd = torch_cuda_group_norm(
      x, gamma, beta, epilogue == "relu6", res)
  got, mean, rstd = group_norm_cuda.launch(
      emulated, torch.from_numpy(x), torch.from_numpy(gamma),
      torch.from_numpy(beta), EPS, relu6=epilogue == "relu6",
      residual=None if res is None else torch.from_numpy(res), stream=None,
      stats=True)
  np.testing.assert_array_equal(mean.numpy().reshape(-1), want_mean)
  np.testing.assert_array_equal(rstd.numpy().reshape(-1), want_rstd)
  np.testing.assert_array_equal(got.numpy(), want)
  # The restatement is GroupNorm: PyTorch's CPU operations agree to
  # float32 rounding.
  plain = group_norm_cuda.group_norm_reference(
      torch.from_numpy(x), torch.from_numpy(gamma), torch.from_numpy(beta),
      EPS, relu6=epilogue == "relu6",
      residual=None if res is None else torch.from_numpy(res))
  np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-5,
                             atol=1e-5)
  if epilogue == "relu6":
    assert got.min() == 0 and got.max() <= 6 and (got > 0).any()


def test_emulated_entry_point_refuses_what_the_kernel_does_not_take(
    emulated):
  x = torch.zeros(1, 8, 4, 4)
  gamma, beta = torch.ones(8), torch.zeros(8)
  y = torch.empty_like(x)
  call = emulated.group_norm_launch
  ok = (x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), None,
        y.data_ptr(), None, None, 1, 1, 16, EPS, 0, None)
  assert call(*ok) == 0
  for i, bad in ((9, 0),                 # an empty row
                 (9, 2**28),             # a row past 2**31 floats
                 (11, 2),                # the residual epilogue, no residual
                 (11, 3),                # no such epilogue
                 (8, 2)):                # 1 row, 2 groups a sample
    args = list(ok)
    args[i] = bad
    assert call(*args) != 0, (i, bad)
