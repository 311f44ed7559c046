"""The fusion upsample-and-add kernel's CUDA source, built by g++ for the
CPU and run with each CUDA thread a host thread
(``tests/cuda_emulation/cuda_runtime.h``), against the wrapper's plain
version (``fusion_upsample_cuda.upsample_add_reference``: ATen's source
indices, weights and order, each fused multiply-add rounded once) bit for
bit.

The kernel cannot run here; this holds its tiling (rows of both trunks in
one grid, tiles of several planes, of one, and of a band of one plane's
rows, ragged last tiles and tiles across planes), its column groups and
anchors staged in shared memory, its copy at scale 1, and the entry
point's refusals, through the wrapper's packing of the arguments
(``fusion_upsample_cuda.launch``).  Both sides round as IEEE float32 with
the same fused multiply-adds, so they agree bit for bit.  Skips without
g++.
"""

import pytest
import torch

from oatomobile_torch.ops import fusion_upsample_cuda
from torch_port_helpers import emulated_library

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
  """The kernel's library built from ``csrc/fusion_upsample.cu`` for the
  host."""
  return emulated_library(
      fusion_upsample_cuda.KERNEL,
      tmp_path_factory.mktemp("fusion_upsample_emulated"), launches=1,
      prelude="namespace { alignas(16) float4 smem4[1 << 10]; }\n"
      "std::size_t emulated_smem_bytes() { return sizeof(smem4); }\n")


def inputs(batch: int, channels: int, scale: int, seed: int):
  """Both trunks and both anchor maps, with per-channel spreads."""
  g = torch.Generator().manual_seed(seed)

  def draw(side):
    spread = 0.1 + 3 * torch.rand(1, channels, 1, 1, generator=g)
    return torch.randn(batch, channels, side, side, generator=g) * spread

  side = 8 * scale
  return (draw(side), draw(side)), (draw(8), draw(8))


@pytest.mark.parametrize("batch,channels,scale", [
    (1, 64, 8),      # the four fusions: a plane a tile,
    (1, 128, 4),     # four,
    (1, 256, 2),     # sixteen,
    (1, 512, 1),     # and the copy, 64 planes a tile
    (2, 3, 8),       # six planes over both trunks
    (1, 5, 4),       # a ragged last tile
    (3, 7, 3),       # 42 rows a pass (4 threads idle), tiles across planes
    (1, 3, 5),
    (1, 2, 16),      # a plane in bands of 32 rows
    (1, 3, 1),       # 3 planes of a 64-plane tile
])
def test_emulated_kernel_matches_plain_version_bit_for_bit(
    emulated, batch, channels, scale):
  trunks, anchors = inputs(batch, channels, scale, channels * 10 + scale)
  got = fusion_upsample_cuda.launch(emulated, trunks, anchors, scale,
                                    stream=None)
  for out, trunk, anchor in zip(got, trunks, anchors):
    want = fusion_upsample_cuda.upsample_add_reference(trunk, anchor, scale)
    assert out.shape == want.shape
    assert torch.equal(out.view(torch.int32), want.view(torch.int32))


def test_emulated_entry_point_refuses_what_the_kernel_does_not_take(
    emulated):
  trunks, anchors = inputs(1, 2, 2, 0)
  outs = tuple(torch.empty_like(t) for t in trunks)
  ptrs = [trunks[0].data_ptr(), anchors[0].data_ptr(), outs[0].data_ptr(),
          trunks[1].data_ptr(), anchors[1].data_ptr(), outs[1].data_ptr()]
  call = emulated.fusion_upsample_launch
  ok = ptrs + [2, 2, None]
  assert call(*ok) == 0
  assert call(*(ptrs + [0, 2, None])) == 0  # no plane: nothing to do
  for i, bad in ((6, -1),          # planes
                 (7, 0),           # scale 0
                 (7, 129),         # past the widest map
                 (0, ptrs[0] + 4),  # a misaligned trunk,
                 (1, ptrs[1] + 8),  # anchors
                 (5, ptrs[5] + 4)):  # or output
    args = list(ok)
    args[i] = bad
    assert call(*args) != 0, (i, bad)
