"""The counter-based random draws of the reference, written from the
Threefry-2x32 definition (Salmon et al., "Parallel random numbers: as
easy as 1, 2, 3", SC 2011; 20 rounds) and ``jax.random``'s documented
use of it, not from the program's code.

  - a key is a ``[..., 2]`` pair of 32-bit words;
  - ``split(key, n)``: the hashes of the counters ``(0, i)``, ``i < n``;
  - ``fold_in(key, d)``: the hash of the counter ``(0, d)``;
  - ``random_bits(key, shape)``: the two words of the hash of ``(0, i)``
    over the flat index ``i``, XORed;
  - ``uniform``: the top 23 bits as the mantissa of a float in [1, 2),
    less 1; ``normal``: sqrt(2) * erfinv(u), u uniform on (-1, 1), with
    the single-precision erfinv polynomial (M. Giles, "Approximating the
    erfinv function", GPU Computing Gems, 2011) that XLA evaluates.

The 32-bit words live in int64 tensors; every sum and shift is reduced
modulo 2^32.
"""

import numpy as np
import torch

_WORD = (1 << 32) - 1
# Rotation distances of Threefry-2x32, one a round, cycling every 8.
_R = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA


def _hash(key0, key1, c0, c1):
  """Threefry-2x32 (20 rounds) of counter words (c0, c1) under key words
  (key0, key1); int64 tensors of 32-bit values, broadcast together."""
  k = (key0, key1, key0 ^ key1 ^ _PARITY)
  a = (c0 + k[0]) & _WORD
  b = (c1 + k[1]) & _WORD
  for r in range(20):
    a = (a + b) & _WORD
    d = _R[r % 8]
    b = (((b << d) & _WORD) | (b >> (32 - d))) ^ a
    if r % 4 == 3:
      s = r // 4 + 1  # key injection s (1..5)
      a = (a + k[s % 3]) & _WORD
      b = (b + k[(s + 1) % 3] + s) & _WORD
  return a, b


def PRNGKey(seed, device="cpu") -> torch.Tensor:  # pylint: disable=invalid-name
  """Key of an integer seed (or array of seeds): words (0, seed mod 2^32)."""
  low = np.asarray(seed).astype(np.int64) & _WORD
  return torch.as_tensor(np.stack([np.zeros_like(low), low], axis=-1),
                         device=device)


def from_numpy(keys: np.ndarray, device="cpu") -> torch.Tensor:
  return torch.as_tensor(np.asarray(keys, np.uint32).astype(np.int64),
                         device=device)


def to_numpy(keys: torch.Tensor) -> np.ndarray:
  return keys.cpu().numpy().astype(np.uint32)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
  """``[..., 2]`` -> ``[..., num, 2]``."""
  i = torch.arange(num, dtype=torch.int64, device=key.device)
  a, b = _hash(key[..., :1], key[..., 1:], torch.zeros_like(i), i)
  return torch.stack([a, b], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
  """``data``: an int, or integer tensor of the key batch's shape."""
  if not isinstance(data, torch.Tensor):
    data = torch.full(key.shape[:-1], int(data), dtype=torch.int64,
                      device=key.device)
  d = data.to(torch.int64) & _WORD
  a, b = _hash(key[..., 0], key[..., 1], torch.zeros_like(d), d)
  return torch.stack([a, b], dim=-1)


def random_bits(key: torch.Tensor, shape=()) -> torch.Tensor:
  """``[..., *shape]`` 32-bit words (in int64)."""
  shape = tuple(shape)
  n = int(np.prod(shape)) if shape else 1
  i = torch.arange(n, dtype=torch.int64, device=key.device)
  lead = key.shape[:-1]
  a, b = _hash(key[..., 0].reshape(lead + (1,)),
               key[..., 1].reshape(lead + (1,)), torch.zeros_like(i), i)
  return (a ^ b).reshape(lead + shape)


def uniform(key: torch.Tensor, shape=(), minval=0.0,
            maxval=1.0) -> torch.Tensor:
  """float32 uniform on [minval, maxval)."""
  mantissa = (random_bits(key, shape) >> 9) | 0x3F800000
  unit = mantissa.to(torch.int32).view(torch.float32) - 1.0
  lo, hi = np.float32(minval), np.float32(maxval)
  return torch.clamp_min(unit * float(hi - lo) + float(lo), float(lo))


# Giles' single-precision erfinv: coefficients for w < 5 and w >= 5, from
# the highest power down.
_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
          0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
          1.50140941)
_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
          0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
          2.83297682)


def erfinv(x: torch.Tensor) -> torch.Tensor:
  w = -torch.log1p(-x * x)
  small = w < 5.0
  w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)
  p = torch.where(small, _SMALL[0], _LARGE[0])
  for cs, cl in zip(_SMALL[1:], _LARGE[1:]):
    p = torch.where(small, cs, cl) + p * w
  return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def normal(key: torch.Tensor, shape=()) -> torch.Tensor:
  """float32 standard normal."""
  lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
  u = uniform(key, shape, lo, 1.0)
  return float(np.float32(np.sqrt(2))) * erfinv(u)
