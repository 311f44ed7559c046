"""JAX's threefry2x32 PRNG in torch, bit-exact.

Randomness drives NPC junction turns (sim/traffic.py), the pedestrian
walk, the autopilot's epsilon-noise (sim/autopilot.py), per-scene keys
(sim/world.py) and the auto-reset streams (envs/batched.py).  A rollout
with traffic matches the JAX package only if these streams match bit for
bit, so this module reproduces ``jax.random`` under the default
``jax_threefry_partitionable=True`` scheme:

  - a key is a ``[..., 2]`` pair of uint32 words;
  - ``split(key, n)`` hashes the counters ``(0, i)`` for ``i < n``;
  - ``fold_in(key, d)`` hashes the counter ``(0, d)``;
  - ``random_bits(key, shape)`` hashes ``(0, i)`` over the flat index
    ``i`` of ``shape`` and XORs the two output words.

torch has no full uint32 arithmetic, so the words are held in int64
tensors and every sum and shift is masked back to 32 bits.  Every function
takes a batch of keys ``[..., 2]`` and returns its result per key.
"""

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
  return ((x << d) | (x >> (32 - d))) & _MASK


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor):
  """The Threefry-2x32 hash (20 rounds) of counters ``(x0, x1)`` under key
  ``(k0, k1)``; all int64 holding uint32 values, broadcast together."""
  ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
  x0 = (x0 + ks[0]) & _MASK
  x1 = (x1 + ks[1]) & _MASK
  for i in range(5):
    for r in _ROTATIONS[i % 2]:
      x0 = (x0 + x1) & _MASK
      x1 = _rotl(x1, r) ^ x0
    x0 = (x0 + ks[(i + 1) % 3]) & _MASK
    x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
  return x0, x1


def PRNGKey(seed, device="cpu") -> torch.Tensor:  # pylint: disable=invalid-name
  """Key of an integer seed (or an array of seeds): ``(0, seed mod
  2^32)``, as ``jax.random.PRNGKey`` gives with 64-bit types off (the JAX
  package's setting), where the seed is a 32-bit integer."""
  lo = np.asarray(seed).astype(np.int64) & _MASK
  return torch.as_tensor(np.stack([np.zeros_like(lo), lo], axis=-1),
                         device=device)


def from_numpy(keys: np.ndarray, device="cpu") -> torch.Tensor:
  """uint32 key words (as ``np.asarray`` of a JAX key gives) -> key tensor."""
  return torch.as_tensor(np.asarray(keys, np.uint32).astype(np.int64),
                         device=device)


def to_numpy(keys: torch.Tensor) -> np.ndarray:
  """Key tensor -> uint32 words, comparable with a JAX key."""
  return keys.cpu().numpy().astype(np.uint32)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
  """``[..., 2]`` -> ``[..., num, 2]`` subkeys."""
  k0, k1 = key[..., 0:1], key[..., 1:2]
  counts = torch.arange(num, dtype=torch.int64, device=key.device)
  b0, b1 = threefry2x32(k0, k1, torch.zeros_like(counts), counts)
  return torch.stack([b0, b1], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
  """Folds ``data`` (an int, or an integer tensor of the key batch shape)
  into ``key``."""
  if not isinstance(data, torch.Tensor):
    # A fill, not a host-to-device copy of a Python int.
    data = torch.full(key.shape[:-1], int(data), dtype=torch.int64,
                      device=key.device)
  data = data.to(torch.int64) & _MASK
  b0, b1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                        data)
  return torch.stack([b0, b1], dim=-1)


def random_bits(key: torch.Tensor, shape=()) -> torch.Tensor:
  """``[..., *shape]`` uint32 random words (in int64)."""
  shape = tuple(shape)
  n = int(np.prod(shape)) if shape else 1
  counts = torch.arange(n, dtype=torch.int64, device=key.device)
  lead = key.shape[:-1]
  k0 = key[..., 0].reshape(lead + (1,))
  k1 = key[..., 1].reshape(lead + (1,))
  b0, b1 = threefry2x32(k0, k1, torch.zeros_like(counts), counts)
  return (b0 ^ b1).reshape(lead + shape)


def uniform(key: torch.Tensor, shape=(), minval=0.0,
            maxval=1.0) -> torch.Tensor:
  """float32 uniform on ``[minval, maxval)``, as ``jax.random.uniform``:
  the top 23 bits become the mantissa of a float in [1, 2), minus 1.

  Bit-exact when ``maxval - minval`` is a power of two (every call site):
  otherwise XLA on the CPU fuses the scale-and-shift into an FMA and may
  round the last bit differently."""
  bits = random_bits(key, shape)
  float_bits = (bits >> 9) | 0x3F800000
  # Reinterpret the low 32 bits as float32 (values < 2^31 fit int32).
  floats = float_bits.to(torch.int32).view(torch.float32) - 1.0
  lo, hi = np.float32(minval), np.float32(maxval)
  return torch.clamp_min(floats * float(hi - lo) + float(lo), float(lo))


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2)))
# Giles' single-precision erfinv, the polynomial XLA expands ``erf_inv``
# into (w < 5 and w >= 5 branches), so the port rounds as XLA does instead
# of through torch.erfinv's own algorithm (which differs by up to 2e-5).
_ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                  -4.39150654e-06, 0.00021858087, -0.00125372503,
                  -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                  -0.00367342844, 0.00573950773, -0.0076224613,
                  0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: torch.Tensor) -> torch.Tensor:
  """float32 erfinv in XLA's formulation."""
  w = -torch.log1p(-x * x)
  lt = w < 5.0
  w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
  p = torch.where(lt, _ERFINV_W_LT_5[0], _ERFINV_W_GE_5[0])
  for c_lt, c_ge in zip(_ERFINV_W_LT_5[1:], _ERFINV_W_GE_5[1:]):
    p = torch.where(lt, c_lt, c_ge) + p * w
  return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def normal(key: torch.Tensor, shape=()) -> torch.Tensor:
  """float32 standard normal, as ``jax.random.normal``: sqrt(2) *
  erfinv(u) with u uniform on (-1, 1).  The uniforms are bit-exact; the
  result is within 1e-6 of JAX's, because ``log1p`` inside erfinv may
  differ from XLA's in its last ulp."""
  u = uniform(key, shape, _NORMAL_LO, 1.0)
  return _SQRT2 * erfinv(u)
