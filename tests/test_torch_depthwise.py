"""The encoder's routing to the depthwise kernel, and the kernel wrapper's
checks, on the CPU.

``models/perception``'s MobileNetV2 takes ``ops/depthwise_cuda`` for each
of its 17 depthwise convolutions where ``depthwise_cuda.engages``: a
float32 CUDA tensor with autograd off.  Here the tensors are made to say
they are on CUDA (``card_like``: ``Tensor.is_cuda`` patched), so the real
predicate and the real routing run, and the wrapper, seeing CPU tensors,
runs its plain version; a spy records each call's stride and padding.
The kernel itself is held against PyTorch on the card
(``tests/test_torch_cuda.py``) and its source under emulation
(``tests/test_torch_depthwise_emulated.py``).
"""

import types

import pytest
import torch
import torch.nn.functional as F

from oatomobile_torch.baselines.learned.dim import policy as dim_policy
from oatomobile_torch.models import ImitativeModel, MobileNetV2, perception
from oatomobile_torch.ops import depthwise_cuda

torch.set_num_threads(1)

# The encoder's 17 depthwise layers on a 100 x 100 input: (stride,
# padding) in order; block_1's 50 -> 25 is the uneven one.
SAME = (1, 1, 1, 1)
LAYERS_100 = ([(1, SAME), (2, (0, 1, 0, 1)), (1, SAME), (2, SAME)] +
              [(1, SAME)] * 2 + [(2, SAME)] + [(1, SAME)] * 6 +
              [(2, SAME)] + [(1, SAME)] * 3)


@pytest.fixture
def card_like(monkeypatch):
  """Every tensor says it is on CUDA; returns the (stride, padding) of the
  calls that reach the wrapper."""
  monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
  calls = []
  wrapper = depthwise_cuda.depthwise

  def spy(x, weight, stride, padding):
    calls.append((stride, padding))
    return wrapper(x, weight, stride, padding)

  monkeypatch.setattr(depthwise_cuda, "depthwise", spy)
  return calls


@pytest.fixture
def pads(monkeypatch):
  """The paddings ``models/perception`` asks ``F.pad`` for."""
  calls = []

  def pad(x, padding, *args, **kwargs):
    calls.append(tuple(padding))
    return F.pad(x, padding, *args, **kwargs)

  functional = {k: getattr(F, k) for k in dir(F) if not k.startswith("__")}
  functional["pad"] = pad
  monkeypatch.setattr(perception, "F", types.SimpleNamespace(**functional))
  return calls


def encoder(seed: int = 0) -> MobileNetV2:
  return MobileNetV2(generator=torch.Generator().manual_seed(seed),
                     device="cpu").requires_grad_(False)


def images(size: int, batch: int = 2) -> torch.Tensor:
  return torch.rand(batch, 2, size, size,
                    generator=torch.Generator().manual_seed(size))


# F.pad's copies on the plain path: the stem's, and the uneven stride-2
# depthwise layers' (100: block_1; 32: blocks 1, 3, 6 and 13).
@pytest.mark.parametrize("size,plain_pads", [(100, 2), (32, 5)])
def test_no_grad_float32_forward_routes_every_depthwise_layer_to_the_kernel(
    card_like, pads, size, plain_pads):
  model, x = encoder(), images(size)
  with torch.enable_grad():  # the plain path
    want = model(x)
  assert not card_like
  assert pads == [(0, 1, 0, 1)] * plain_pads
  pads.clear()
  with torch.no_grad():
    got = model(x)
  assert len(card_like) == 17
  if size == 100:
    assert card_like == LAYERS_100
  # No depthwise layer pads through F.pad; the stem still does.
  assert pads == [perception.same_padding(size, 3, 2) * 2]
  # The wrapper's plain version rounds each tap's multiply-add once, as the
  # kernel and PyTorch's CUDA kernel do; PyTorch's CPU convolution sums
  # in other orders: equal to float32 rounding.
  torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_autograd_forward_keeps_the_plain_path(card_like):
  model, x = encoder(), images(32)
  model.requires_grad_(True)
  grads = torch.autograd.grad(model(x).square().sum(),
                              list(model.parameters()))
  assert not card_like
  model_plain = encoder()
  model_plain.requires_grad_(True)
  with pytest.MonkeyPatch.context() as mp:  # tensors on the CPU again
    mp.setattr(torch.Tensor, "is_cuda", property(lambda self: False))
    want = torch.autograd.grad(model_plain(x).square().sum(),
                               list(model_plain.parameters()))
  for g, w in zip(grads, want):
    assert torch.equal(g, w)


@pytest.mark.parametrize("dtype,launched", [("float32", 17),
                                            ("bfloat16", 0)])
def test_policy_encode_takes_the_kernel_in_float32_only(card_like, dtype,
                                                        launched):
  model = ImitativeModel((4, 2), (32, 32),
                         generator=torch.Generator().manual_seed(3),
                         device="cpu").requires_grad_(False)
  enc = dim_policy.encoder_copy(model, dtype)
  context = {"visual_features": images(32),
             "velocity": torch.ones(2, 3),
             "is_at_traffic_light": torch.zeros(2, 1),
             "traffic_light_state": torch.ones(2, 1)}
  z = dim_policy.encode(enc, context)
  assert len(card_like) == launched
  assert z.dtype == torch.float32 and z.shape == (2, 64)


def test_engages_only_where_the_kernel_runs(card_like):
  x = torch.zeros(2, 16, 7, 7)
  with torch.no_grad():
    assert depthwise_cuda.engages(x)
    assert not depthwise_cuda.engages(x.to(torch.bfloat16))
    assert not depthwise_cuda.engages(x.double())
    # Shapes are the wrapper's to refuse, not a reason for the plain path.
    assert depthwise_cuda.engages(torch.zeros(1, 8, 3, 2000))
  assert not depthwise_cuda.engages(x)  # autograd on


def test_engages_never_on_cpu_tensors():
  with torch.no_grad():
    assert not depthwise_cuda.engages(torch.zeros(2, 16, 7, 7))


def test_no_grad_convolution_the_kernel_does_not_take_raises(card_like):
  """A float32 no-grad depthwise layer on the card whose input the kernel
  does not take (rows past 1,365 floats here) raises: it does not quietly
  run PyTorch's operations."""
  block = perception.InvertedResidual(8, 8, 1, 1)
  block.to_empty(device="cpu")
  with torch.no_grad(), pytest.raises(ValueError, match="rows of at most"):
    block(torch.zeros(1, 8, 3, 1400))
  assert card_like == [(1, SAME)]


def _args(**changes):
  args = dict(x=torch.randn(2, 16, 5, 5), weight=torch.randn(16, 1, 3, 3),
              stride=1, padding=SAME)
  args.update(changes)
  return args


@pytest.mark.parametrize("changes,error", [
    (dict(x=torch.randn(2, 16, 5, 5).transpose(2, 3)), ValueError),
    (dict(weight=torch.randn(16, 1, 3, 3).transpose(2, 3)), ValueError),
    (dict(x=torch.randn(2, 16, 5, 5, dtype=torch.float64)), TypeError),
    (dict(x=torch.randn(2, 16, 5, 5).to(torch.bfloat16)), TypeError),
    (dict(weight=torch.randn(16, 1, 3, 3, dtype=torch.float64)), TypeError),
    (dict(weight=torch.randn(16, 1, 5, 5)), ValueError),
    (dict(weight=torch.randn(16, 1, 1, 1)), ValueError),
    (dict(weight=torch.randn(8, 1, 3, 3)), ValueError),
    (dict(weight=torch.randn(16, 2, 3, 3)), ValueError),
    (dict(x=torch.randn(16, 5, 5)), ValueError),
    (dict(stride=3), ValueError),
    (dict(padding=(3, 3, 1, 1)), ValueError),
    (dict(padding=(1, 1, -1, 1)), ValueError),
    (dict(padding=(1, 1)), ValueError),
    (dict(x=torch.randn(1, 16, 1, 1), padding=(0, 0, 0, 0)), ValueError),
    (dict(x=torch.randn(1, 16, 2, 1366)), ValueError),
], ids=["non-contiguous", "weight-strides", "float64", "bfloat16",
        "weight-dtype", "kernel-5", "kernel-1", "weight-channels",
        "weight-groups", "3-d", "stride-3", "padding-3", "padding-negative",
        "padding-two", "no-output", "too-wide"])
def test_wrapper_refuses_what_the_kernel_does_not_take(changes, error):
  args = _args(**changes)
  before = depthwise_cuda.KERNEL.launches
  with pytest.raises(error):
    depthwise_cuda.depthwise(**args)
  assert depthwise_cuda.KERNEL.launches == before


@pytest.mark.parametrize("stride,padding", [(1, SAME), (2, (0, 1, 0, 1)),
                                            (2, SAME)])
def test_wrapper_runs_the_plain_version_on_cpu(stride, padding):
  x, weight = torch.randn(2, 16, 9, 10), torch.randn(16, 1, 3, 3)
  before = depthwise_cuda.KERNEL.launches
  got = depthwise_cuda.depthwise(x, weight, stride, padding)
  assert torch.equal(got, depthwise_cuda.depthwise_reference(
      x, weight, stride, padding))
  want = perception.same_conv(x, weight, stride, padding, groups=16)
  assert got.shape == want.shape
  torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
  assert depthwise_cuda.KERNEL.launches == before
