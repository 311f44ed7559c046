"""The encoder's routing to the GroupNorm kernel, and the kernel wrapper's
checks, on the CPU.

``models/perception``'s MobileNetV2 takes ``ops/group_norm_cuda`` for
each GroupNorm and what follows it where ``group_norm_cuda.engages``: a
float32 CUDA tensor with autograd off.  Here the tensors are made to say
they are on CUDA (``card_like``: ``Tensor.is_cuda`` patched), so the real
predicate and the real routing run, and the wrapper, seeing CPU tensors,
runs its plain version; a spy records each call's epilogue.  The kernel
itself is held against PyTorch on the card (``tests/test_torch_cuda.py``)
and its source under emulation (``tests/test_torch_group_norm_emulated.py``).
"""

import pytest
import torch

from oatomobile_torch.baselines.learned.dim import policy as dim_policy
from oatomobile_torch.models import ImitativeModel, MobileNetV2
from oatomobile_torch.ops import depthwise_cuda, group_norm_cuda

torch.set_num_threads(1)

# The encoder's 52 GroupNorms: 35 followed by ReLU6, 10 by the residual
# add, 7 by nothing.
EPILOGUES = {"relu6": 35, "residual": 10, "none": 7}


@pytest.fixture
def card_like(monkeypatch):
  """Every tensor says it is on CUDA; returns the epilogues of the calls
  that reach the wrapper.  The depthwise layers keep PyTorch's path (their
  kernel's routing is ``tests/test_torch_depthwise.py``'s), so that the
  forwards differ by the GroupNorms' routing alone."""
  monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
  monkeypatch.setattr(depthwise_cuda, "engages", lambda x: False)
  calls = []
  wrapper = group_norm_cuda.group_norm

  def spy(x, weight, bias, eps, *, relu6=False, residual=None):
    calls.append("relu6" if relu6 else
                 "none" if residual is None else "residual")
    return wrapper(x, weight, bias, eps, relu6=relu6, residual=residual)

  monkeypatch.setattr(group_norm_cuda, "group_norm", spy)
  return calls


def encoder(seed: int = 0) -> MobileNetV2:
  """A MobileNetV2 whose GroupNorms have random scales and biases."""
  g = torch.Generator().manual_seed(seed)
  model = MobileNetV2(generator=g, device="cpu").requires_grad_(False)
  for m in model.modules():
    if isinstance(m, torch.nn.GroupNorm):
      m.weight.copy_(1 + 0.5 * torch.randn(m.weight.shape, generator=g))
      m.bias.copy_(torch.randn(m.bias.shape, generator=g))
  return model


def images(size: int, batch: int = 2) -> torch.Tensor:
  return torch.rand(batch, 2, size, size,
                    generator=torch.Generator().manual_seed(size))


def counts(calls) -> dict:
  return {k: calls.count(k) for k in EPILOGUES}


# 32 reaches 1 x 1 maps; 104's first stage has rows of 8 x 52 x 52 floats,
# past what the kernel holds in registers.
@pytest.mark.parametrize("size", [100, 32, 104])
def test_no_grad_float32_forward_routes_every_norm_to_the_kernel(
    card_like, size):
  model, x = encoder(), images(size)
  with torch.enable_grad():  # the plain path
    want = model(x)
  assert not card_like
  with torch.no_grad():
    got = model(x)
  assert counts(card_like) == EPILOGUES
  # On the CPU the wrapper's plain version runs PyTorch's operations in
  # the plain path's order: bit for bit.
  assert torch.equal(got, want)


def test_autograd_forward_keeps_the_plain_path(card_like):
  model, x = encoder(), images(32)
  model.requires_grad_(True)
  params = list(model.parameters())
  grads = torch.autograd.grad(model(x).square().sum(), params)
  assert not card_like
  model_plain = encoder()
  model_plain.requires_grad_(True)
  with pytest.MonkeyPatch.context() as mp:  # tensors on the CPU again
    mp.setattr(torch.Tensor, "is_cuda", property(lambda self: False))
    want = torch.autograd.grad(model_plain(x).square().sum(),
                               list(model_plain.parameters()))
  for g, w in zip(grads, want):
    assert torch.equal(g, w)


@pytest.mark.parametrize("dtype,launched", [("float32", 52),
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
    assert group_norm_cuda.engages(x)
    assert not group_norm_cuda.engages(x.to(torch.bfloat16))
    # Shapes are the wrapper's to refuse, not a reason for the plain path.
    assert group_norm_cuda.engages(torch.zeros(2, 12, 7, 7))
    assert group_norm_cuda.engages(torch.zeros(1, 8, 51, 51))
  assert not group_norm_cuda.engages(x)  # autograd on


def test_no_grad_norm_the_kernel_does_not_take_raises(card_like):
  """A float32 no-grad GroupNorm on the card whose shape the kernel does
  not take (groups of 4 channels here) raises: it does not quietly run
  PyTorch's operations."""
  from oatomobile_torch.models import perception  # pylint: disable=import-outside-toplevel
  norm = torch.nn.GroupNorm(3, 12)
  with torch.no_grad(), pytest.raises(ValueError):
    perception._normalise(norm, torch.zeros(2, 12, 7, 7), relu6=True)  # pylint: disable=protected-access
  assert card_like == ["relu6"]


def test_engages_never_on_cpu_tensors():
  with torch.no_grad():
    assert not group_norm_cuda.engages(torch.zeros(2, 16, 7, 7))


def _args(**changes):
  args = dict(x=torch.randn(2, 16, 5, 5), weight=torch.randn(16),
              bias=torch.randn(16), eps=1e-6, relu6=False, residual=None)
  args.update(changes)
  return args


@pytest.mark.parametrize("changes,error", [
    (dict(x=torch.randn(2, 16, 5, 5).transpose(2, 3)), ValueError),
    (dict(x=torch.randn(2, 12, 5, 5), weight=torch.randn(12),
          bias=torch.randn(12)), ValueError),
    (dict(x=torch.randn(2, 16, 5, 5, dtype=torch.float64)), TypeError),
    (dict(x=torch.randn(2, 16, 5, 5).to(torch.bfloat16)), TypeError),
    (dict(weight=torch.randn(8)), ValueError),
    (dict(bias=torch.randn(16, dtype=torch.float64)), TypeError),
    (dict(x=torch.randn(16, 5, 5)), ValueError),
    (dict(residual=torch.randn(2, 16, 5, 4)), ValueError),
    (dict(residual=torch.randn(2, 16, 5, 5).transpose(2, 3)), ValueError),
    (dict(relu6=True, residual=torch.randn(2, 16, 5, 5)), ValueError),
], ids=["non-contiguous", "channels", "float64", "bfloat16", "weight-shape",
        "bias-dtype", "3-d", "residual-shape",
        "residual-strides", "two-epilogues"])
def test_wrapper_refuses_what_the_kernel_does_not_take(changes, error):
  args = _args(**changes)
  before = group_norm_cuda.KERNEL.launches
  with pytest.raises(error):
    group_norm_cuda.group_norm(args.pop("x"), args.pop("weight"),
                               args.pop("bias"), args.pop("eps"), **args)
  assert group_norm_cuda.KERNEL.launches == before


@pytest.mark.parametrize("epilogue", ["none", "relu6", "residual"])
def test_wrapper_runs_the_plain_version_on_cpu(epilogue):
  args = _args(relu6=epilogue == "relu6",
               residual=(torch.randn(2, 16, 5, 5) if epilogue == "residual"
                         else None))
  x, weight, bias = args["x"], args["weight"], args["bias"]
  before = group_norm_cuda.KERNEL.launches
  got = group_norm_cuda.group_norm(x, weight, bias, 1e-6,
                                   relu6=args["relu6"],
                                   residual=args["residual"])
  want = torch.nn.functional.group_norm(x, 2, weight, bias, 1e-6)
  if epilogue == "relu6":
    want = torch.nn.functional.relu6(want)
  if epilogue == "residual":
    want = args["residual"] + want
  assert torch.equal(got, want)
  assert group_norm_cuda.KERNEL.launches == before
