"""TransFuser's routing to the fusion upsample-and-add kernel, the kernel
wrapper's checks and its plain version, on the CPU.

``models/transfuser``'s encoder takes ``ops/fusion_upsample_cuda`` for
each of its four fusions where ``fusion_upsample_cuda.engages``: a float32
CUDA trunk map with autograd off.  Here the tensors are made to say they
are on CUDA (``card_like``: ``Tensor.is_cuda`` patched), so the real
predicate and the real routing run, and the wrapper, seeing CPU tensors,
runs its plain version; a spy records each call's trunk shape and scale.
The kernel itself is held against PyTorch on the card
(``tests/test_torch_cuda.py``) and its source under emulation
(``tests/test_torch_fusion_upsample_emulated.py``).
"""

import pytest
import torch
import torch.nn.functional as F

from oatomobile_torch.models.transfuser import TransFuser
from oatomobile_torch.ops import fusion_upsample_cuda

torch.set_num_threads(1)

# The four fusions of the model's 256 x 256 input: (channels, scale), the
# trunk maps 8 x scale pixels a side.
FUSIONS = [(64, 8), (128, 4), (256, 2), (512, 1)]
# Scales the model would take at other input sizes (maps of 24, 40, 48 and
# 96 pixels), and a map cut into row bands (128 pixels).
OTHER_SCALES = [(5, 3), (3, 5), (7, 6), (2, 12), (1, 16)]


def case(batch: int, channels: int, scale: int, seed: int):
  """(trunk, anchors) with per-channel spreads."""
  g = torch.Generator().manual_seed(seed)
  side = 8 * scale

  def draw(size):
    spread = 0.1 + 3 * torch.rand(1, channels, 1, 1, generator=g)
    return torch.randn(batch, channels, size, size, generator=g) * spread

  return draw(side), draw(8)


def library(trunk, anchors, scale):
  return trunk + F.interpolate(anchors, scale_factor=scale, mode="bilinear",
                               align_corners=False)


@pytest.mark.parametrize("channels,scale", FUSIONS + OTHER_SCALES)
def test_plain_version_is_pytorch_s_upsample_and_add(channels, scale):
  """The plain version rounds as ATen's CUDA kernel does; PyTorch's CPU
  upsampling rounds its weights and sums otherwise: equal to float32
  rounding, and exactly at scale 1 (a copy, then the add)."""
  trunk, anchors = case(2, channels, scale, channels + scale)
  got = fusion_upsample_cuda.upsample_add_reference(trunk, anchors, scale)
  want = library(trunk, anchors, scale)
  assert got.shape == trunk.shape and got.dtype == torch.float32
  if scale == 1:
    assert torch.equal(got, want)
  else:
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_plain_version_keeps_aten_s_weights_and_edges():
  """Anchors that are their column index: inside, the upsampled row is a
  straight line between the anchors' centres; outside them, clamped to
  the edge anchors (ATen's source index clamped at 0, its last column's
  step of 0)."""
  scale = 4
  anchors = torch.arange(8.0).expand(1, 1, 8, 8).contiguous()
  got = fusion_upsample_cuda.upsample_add_reference(
      torch.zeros(1, 1, 32, 32), anchors, scale)
  centres = (torch.arange(32.0) + 0.5) / scale - 0.5
  assert torch.equal(got[0, 0, 5], centres.clamp(0, 7))


@pytest.fixture
def card_like(monkeypatch):
  """Every tensor says it is on CUDA; returns the (trunk shape, scale) of
  the calls that reach the wrapper."""
  monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
  calls = []
  wrapper = fusion_upsample_cuda.upsample_add

  def spy(trunks, anchors, scale):
    calls.append((tuple(trunks[0].shape), scale))
    return wrapper(trunks, anchors, scale)

  monkeypatch.setattr(fusion_upsample_cuda, "upsample_add", spy)
  return calls


def model_inputs(batch: int = 1, seed: int = 0):
  g = torch.Generator().manual_seed(seed)
  model = TransFuser(device="cpu").eval().requires_grad_(False)
  return model, (torch.randn(batch, 3, 256, 256, generator=g),
                 torch.rand(batch, 2, 256, 256, generator=g),
                 4 * torch.rand(batch, generator=g))


def test_no_grad_float32_encode_routes_every_fusion_to_the_kernel(card_like):
  model, inputs = model_inputs()
  with torch.enable_grad():  # the plain path
    want = model.encode(*inputs)
  assert not card_like
  with torch.no_grad():
    got = model.encode(*inputs)
  assert card_like == [((1, c, 8 * s, 8 * s), s) for c, s in FUSIONS]
  # The wrapper's plain version rounds as ATen's CUDA kernel; the plain
  # path here is PyTorch's CPU upsampling: equal to float32 rounding.
  torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_autograd_encode_keeps_pytorch_s_operations(card_like):
  model, inputs = model_inputs()
  model.requires_grad_(True)
  z = model.encode(*inputs)
  grads = torch.autograd.grad(z.square().sum(),
                              [model.encoder.transformer1.pos_emb])
  assert not card_like
  assert grads[0].abs().sum() > 0


def test_a_float64_model_keeps_pytorch_s_operations(card_like):
  model, inputs = model_inputs()
  model.double()
  with torch.no_grad():
    z = model.encode(*(x.double() for x in inputs))
  assert not card_like and z.dtype == torch.float64


def test_engages_only_where_the_kernel_runs(card_like):
  x = torch.zeros(2, 64, 64, 64)
  with torch.no_grad():
    assert fusion_upsample_cuda.engages(x)
    assert not fusion_upsample_cuda.engages(x.double())
    assert not fusion_upsample_cuda.engages(x.to(torch.bfloat16))
    # Shapes are the wrapper's to refuse, not a reason for PyTorch's path.
    assert fusion_upsample_cuda.engages(torch.zeros(1, 3, 20, 20))
  assert not fusion_upsample_cuda.engages(x)  # autograd on


def test_engages_never_on_cpu_tensors():
  with torch.no_grad():
    assert not fusion_upsample_cuda.engages(torch.zeros(2, 64, 64, 64))
    assert not fusion_upsample_cuda.engages(torch.zeros(2, 64, 64, 64,
                                                        dtype=torch.float64))


def _args(size: int = 2, **changes):
  """A call's arguments at scale ``size`` (the trunks 8 x size pixels),
  with ``changes``."""
  trunks = (torch.randn(2, 16, 8 * size, 8 * size),
            torch.randn(2, 16, 8 * size, 8 * size))
  anchors = (torch.randn(2, 16, 8, 8), torch.randn(2, 16, 8, 8))
  args = dict(trunks=trunks, anchors=anchors, scale=size)
  args.update(changes)
  return args


@pytest.mark.parametrize("changes,error", [
    (dict(trunks=(torch.randn(2, 16, 16, 16).double(),
                  torch.randn(2, 16, 16, 16))), TypeError),
    (dict(anchors=(torch.randn(2, 16, 8, 8),
                   torch.randn(2, 16, 8, 8).to(torch.bfloat16))), TypeError),
    (dict(scale=2.5), TypeError),
    (dict(scale=2.0), TypeError),
    (dict(scale=True), TypeError),
    (dict(scale=0), ValueError),
    (dict(scale=129), ValueError),
    (dict(scale=3), ValueError),   # the trunks are 16 pixels, not 24
    (dict(trunks=(torch.randn(2, 16, 16, 16), torch.randn(2, 16, 16, 17))),
     ValueError),
    (dict(trunks=(torch.randn(2, 16, 16, 16), torch.randn(2, 8, 16, 16))),
     ValueError),
    (dict(anchors=(torch.randn(2, 16, 4, 4), torch.randn(2, 16, 8, 8))),
     ValueError),
    (dict(anchors=(torch.randn(2, 16, 8, 8), torch.randn(1, 16, 8, 8))),
     ValueError),
    (dict(trunks=(torch.randn(16, 16, 16), torch.randn(16, 16, 16))),
     ValueError),
    (dict(trunks=(torch.randn(2, 16, 16, 16),)), ValueError),
    (dict(trunks=(torch.randn(2, 16, 16, 16).transpose(2, 3),
                  torch.randn(2, 16, 16, 16))), ValueError),
    (dict(anchors=(torch.randn(2, 16, 8, 8),
                   torch.randn(2, 8, 8, 16).permute(0, 3, 1, 2))),
     ValueError),
], ids=["trunk-float64", "anchors-bfloat16", "scale-2.5", "scale-float",
        "scale-bool", "scale-0", "scale-129", "scale-not-the-map-s",
        "trunk-not-square", "trunk-channels", "anchors-4x4",
        "anchors-batch", "3-d", "one-trunk", "trunk-non-contiguous",
        "anchors-non-contiguous"])
def test_wrapper_refuses_what_the_kernel_does_not_take(changes, error):
  args = _args(**changes)
  before = fusion_upsample_cuda.KERNEL.launches
  with pytest.raises(error):
    fusion_upsample_cuda.upsample_add(**args)
  assert fusion_upsample_cuda.KERNEL.launches == before


@pytest.mark.parametrize("scale", [1, 2, 3])
def test_wrapper_runs_the_plain_version_on_cpu(scale):
  args = _args(scale)
  before = fusion_upsample_cuda.KERNEL.launches
  got = fusion_upsample_cuda.upsample_add(**args)
  assert len(got) == 2
  for out, trunk, anchors in zip(got, args["trunks"], args["anchors"]):
    assert torch.equal(out, fusion_upsample_cuda.upsample_add_reference(
        trunk, anchors, scale))
    assert out.data_ptr() != trunk.data_ptr()  # a new tensor, as the add
  assert fusion_upsample_cuda.KERNEL.launches == before
