"""The depthwise kernel's CUDA source, built by g++ for the CPU and run with
each CUDA thread a host thread (``tests/cuda_emulation/cuda_runtime.h``),
against the wrapper's plain version (``depthwise_cuda.depthwise_reference``:
ATen's order of the nine taps, each multiply-add rounded once) bit for
bit, and against PyTorch's CPU convolution to float32 rounding.

The kernel cannot run here; this holds its tiling (whole planes a tile,
ragged last tiles, planes cut into bands past 4,096 floats), its
16-byte loads at every alignment of the input, its register window over
stride 1 and 2 and its edge taps left out, through the wrapper's packing
of the arguments (``depthwise_cuda.launch``), and its outputs staged in
shared memory and written with 16-byte stores.  Both sides round as IEEE
float32 with the same fused multiply-adds, so they agree bit for bit.
Skips without g++.
"""

import fractions

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from oatomobile_torch.native import nvcc
from oatomobile_torch.ops import depthwise_cuda
from torch_port_helpers import emulated_library

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
  """The kernel's library built from ``csrc/depthwise_conv.cu`` for the
  host."""
  return emulated_library(
      depthwise_cuda.KERNEL, tmp_path_factory.mktemp("depthwise_emulated"),
      launches=2,
      prelude="namespace { alignas(16) float4 smem4[1 << 12]; }\n"
      "std::size_t emulated_smem_bytes() { return sizeof(smem4); }\n")


def inputs(shape, seed: int, offset: int = 0):
  """x (a contiguous view ``offset`` floats into its storage, so that its
  address takes each alignment) with per-channel spreads, and weights."""
  g = torch.Generator().manual_seed(seed)
  n, c, h, w = shape
  x = torch.randn(offset + n * c * h * w, generator=g)[offset:].view(shape)
  x.mul_(0.1 + 3 * torch.rand(1, c, 1, 1, generator=g))
  weight = torch.randn(c, 1, 3, 3, generator=g) * 0.5
  return x, weight


@pytest.mark.parametrize("shape,stride,padding,offset", [
    ((2, 3, 1, 1), 1, (1, 1, 1, 1), 0),      # 1 x 1 maps: the centre tap
    ((2, 5, 2, 2), 2, (0, 1, 0, 1), 1),      # 2 x 2 -> 1 x 1
    ((3, 4, 4, 4), 1, (1, 1, 1, 1), 2),      # 4 x 4, the encoder's last
    ((3, 100, 4, 4), 1, (1, 1, 1, 1), 3),    # 300 planes: a ragged tile
    ((2, 6, 7, 7), 2, (1, 1, 1, 1), 0),      # 7 -> 4
    ((2, 8, 7, 7), 1, (1, 1, 1, 1), 1),
    ((1, 6, 13, 13), 2, (1, 1, 1, 1), 2),    # 13 -> 7
    ((2, 5, 13, 13), 1, (1, 1, 1, 1), 0),
    ((1, 4, 25, 25), 2, (1, 1, 1, 1), 3),    # 25 -> 13
    ((1, 7, 25, 25), 1, (1, 1, 1, 1), 1),
    ((1, 2, 50, 50), 2, (0, 1, 0, 1), 0),    # 50 -> 25: the uneven pad
    ((1, 2, 50, 50), 1, (1, 1, 1, 1), 2),
    ((1, 1, 70, 70), 1, (1, 1, 1, 1), 1),    # 4,900 floats: bands
    ((1, 2, 70, 70), 2, (0, 1, 0, 1), 3),
    ((2, 3, 5, 9), 2, (2, 0, 0, 2), 0),      # any padding up to 2
    ((1, 3, 6, 11), 1, (0, 2, 2, 0), 1),
    ((1, 2, 3, 1365), 1, (2, 2, 2, 2), 2),   # the widest row; 6,835 outputs
    ((1, 1, 3000, 2), 2, (1, 1, 2, 2), 3),   # bands cut by their outputs
])
def test_emulated_kernel_matches_plain_version_bit_for_bit(
    emulated, shape, stride, padding, offset):
  x, weight = inputs(shape, sum(shape) + stride, offset)
  assert x.data_ptr() % 16 == 4 * offset % 16
  got = depthwise_cuda.launch(emulated, x, weight, stride, padding,
                              stream=None)
  want = depthwise_cuda.depthwise_reference(x, weight, stride, padding)
  assert got.shape == want.shape
  assert torch.equal(got.view(torch.int32), want.view(torch.int32))
  # The plain version is the convolution: PyTorch's CPU operations agree
  # to float32 rounding.
  top, bottom, left, right = padding
  conv = F.conv2d(F.pad(x, (left, right, top, bottom)), weight,
                  stride=stride, groups=shape[1])
  np.testing.assert_allclose(got.numpy(), conv.numpy(), rtol=1e-5,
                             atol=1e-5)


def test_emulated_entry_point_refuses_what_the_kernel_does_not_take(
    emulated):
  x, weight = inputs((1, 2, 6, 6), 0)
  y = torch.empty(1, 2, 16, 16)  # room for what a refusal would write
  call = emulated.depthwise_conv_launch
  ok = [x.data_ptr(), weight.data_ptr(), y.data_ptr(), 2, 2, 6, 6, 6, 6, 1,
        1, 1, None]
  assert call(*ok) == 0
  for i, bad in ((3, 3),           # planes not whole samples
                 (4, 0),           # no channel
                 (6, 1366),        # a row past 1,365 floats
                 (7, 8),           # more output rows than a padding of 2 gives
                 (8, 0),           # no output column
                 (9, 3),           # stride 3
                 (10, 3),          # padding 3
                 (11, -1)):
    args = list(ok)
    args[i] = bad
    assert call(*args) != 0, (i, bad)


# -- the plain version's fused multiply-add --------------------------------


def exact_fma(a: float, b: float, c: float) -> np.float32:
  """a * b + c rounded once to float32 (to nearest, ties to even), from
  the exact rational value."""
  exact = fractions.Fraction(a) * fractions.Fraction(b) + fractions.Fraction(c)
  guess = np.float32(float(exact))
  candidates = [np.nextafter(guess, np.float32(-np.inf)), guess,
                np.nextafter(guess, np.float32(np.inf))]
  best = min(abs(fractions.Fraction(float(v)) - exact) for v in candidates)
  near = [v for v in candidates
          if abs(fractions.Fraction(float(v)) - exact) == best]
  if len(near) == 1:
    return near[0]
  return next(v for v in near if v.view(np.int32) % 2 == 0)


def test_plain_version_rounds_each_multiply_add_once():
  rng = np.random.default_rng(0)
  a, b, c = (rng.normal(size=400).astype(np.float32) *
             np.float32(10.0)**rng.integers(-3, 3, 400).astype(np.float32)
             for _ in range(3))
  # Sums whose float64 value falls on a float32 midpoint that the exact
  # value misses by 2**-70: rounding the float64 sum would take the even
  # neighbour, the fused multiply-add the nearer one.
  one_up = np.float32(1 + 2.0**-23)
  a = np.concatenate([a, [one_up, -one_up, one_up]]).astype(np.float32)
  b = np.concatenate([b, [np.float32(2.0**-24 * (1 - 2.0**-23))] * 3])
  c = np.concatenate([c, [one_up, -one_up, np.float32(-1 - 2.0**-22)]])
  got = nvcc.fmaf(*(torch.from_numpy(v.astype(np.float32))
                    for v in (a, b, c))).numpy()
  want = np.array([exact_fma(float(x), float(y), float(z))
                   for x, y, z in zip(a, b, c)], np.float32)
  np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
  assert got[400] == one_up  # not 1 + 2**-22, the even neighbour
  assert got[400] != np.float32(float(a[400]) * float(b[400]) +
                                float(c[400]))
