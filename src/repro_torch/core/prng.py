"""The port's threefry stream: jax's ``jax.random`` keys, bit for bit.

The JAX package draws every random number it needs from threefry-2x32
keys: the ``random`` scheduling policy (a key split once per visit) and
the random walk's tape (``uniform(fold_in(fold_in(PRNGKey(seed), src),
t))``).  The port reproduces those bits exactly, in jax's default mode
(``jax_threefry_partitionable`` on, 64-bit types off):

* ``PRNGKey(s)`` is ``[0, s mod 2^32]`` (the seed is read as 32 bits);
* ``fold_in(k, d)`` is the hash of the counter ``(0, d)`` under ``k``;
* ``split(k, num)``: new key ``i`` is the hash of the counter ``(0, i)``;
* ``bits(k, shape)``: element ``i`` (row-major) is ``o1 ^ o2`` of the
  counter ``(0, i)`` (jax's 32-bit ``random_bits``);
* ``uniform(k, shape, minval=, maxval=)``: the top 23 bits of element
  ``i``'s bits are the mantissa of a float in [1, 2), less one, then
  ``max(minval, f * (maxval - minval) + minval)`` in float32 with one
  rounding (a fused multiply-add, as jax's CPU code computes it);
* ``randint(k, shape, minval, maxval)``: jax's int32 algorithm, two bit
  draws (of ``split(k)``'s keys) reduced modulo the span with 32-bit
  wrap-around;
* ``normal(k, shape)``: ``sqrt(2) * erfinv(u)`` of a uniform in
  ``(-1, 1)``; ``erfinv`` is torch's, which differs from XLA's
  polynomial by a few float32 ulps.

A key is an int64 tensor ``[2]`` holding two 32-bit words (torch has no
uint32 arithmetic); a batch of keys is ``[N, 2]``.  Every function works
on the key's device: on the CPU the plain version
(``kernels/threefry/ref.py``), on the card one launch of the threefry
kernel (``kernels/threefry/ops.py``).
"""
from __future__ import annotations

import math
from typing import Sequence, Union

import numpy as np
import torch

from repro_torch.kernels.threefry import ops as _ops
from repro_torch.kernels.threefry.ref import M32

Shape = Union[int, Sequence[int]]


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """The key of ``seed`` (int64 ``[2]``), as ``jax.random.PRNGKey``."""
    return torch.tensor([0, int(seed) & M32], dtype=torch.int64,
                        device=device)


def threefry2x32(k1, k2, x1, x2):
    """The threefry-2x32 hash, elementwise over broadcast int64 tensors of
    32-bit words: ``(o1, o2)`` of the counter ``(x1, x2)`` under the key
    ``(k1, k2)``."""
    k1, k2, x1, x2 = torch.broadcast_tensors(*(
        torch.as_tensor(v, dtype=torch.int64) for v in (k1, k2, x1, x2)))
    shape = k1.shape
    key = torch.stack([k1.reshape(-1), k2.reshape(-1)], dim=1)
    n = key.shape[0]
    o1, o2 = _ops.draw(key, n, x1=x1.reshape(-1), x2=x2.reshape(-1))
    return o1.reshape(shape), o2.reshape(shape)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``key`` ``[2]`` (with an int ``data``) or ``[N, 2]`` (with ``data``
    an int or ``[N]``) with ``data`` folded in."""
    keys = key.reshape(-1, 2)
    n = keys.shape[0]
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device)
    d = d.expand(n).contiguous() if d.dim() == 0 else d
    o1, o2 = _ops.draw(keys if n > 1 else keys[0], n, x2=d)
    return torch.stack([o1, o2], dim=1).reshape(key.shape)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``num`` new keys ``[num, 2]`` from ``key`` ``[2]``; the engine's
    ``key, sub = split(key)`` carries row 0 and draws with row 1."""
    o1, o2 = _ops.draw(key, int(num))
    return torch.stack([o1, o2], dim=1)


def _shape(shape: Shape) -> tuple:
    return (shape,) if isinstance(shape, int) else tuple(shape)


def uniform(key: torch.Tensor, shape: Shape = (), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """float32 uniforms in [minval, maxval): of ``shape`` under one key
    ``[2]``, or one per key of ``[N, 2]`` (``shape`` must then be ``()``:
    the vmapped ``jax.random.uniform(key)``).  The scaling is jax's,
    ``max(minval, f * (maxval - minval) + minval)`` rounded once to
    float32."""
    shape = _shape(shape)
    if key.dim() == 2:
        if shape:
            raise ValueError("uniform over a batch of keys draws one value "
                             "per key; pass shape=()")
        f = _ops.draw(key, key.shape[0], iota=False, uniform=True)
    else:
        f = _ops.draw(key, math.prod(shape), uniform=True).reshape(shape)
    if (minval, maxval) == (0.0, 1.0):
        return f                  # f * 1 + 0, then max(0, f): f itself
    lo, hi = np.float32(minval), np.float32(maxval)
    # jax's CPU code fuses the multiply-add: one rounding, which float64
    # gives (the float32 product is exact there, and so is the sum for
    # bounds of like magnitude)
    f = (f.double() * float(hi - lo) + float(lo)).float()
    return torch.clamp(f, min=float(lo))


def bits(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """jax's 32-bit random bits of ``shape`` under ``key [2]``, as int64
    words in ``[0, 2^32)``."""
    shape = _shape(shape)
    o1, o2 = _ops.draw(key, math.prod(shape))
    return (o1 ^ o2).reshape(shape)


def randint(key: torch.Tensor, shape: Shape, minval: int,
            maxval: int) -> torch.Tensor:
    """int32 integers in ``[minval, maxval)`` (``minval`` when the range is
    empty), as ``jax.random.randint`` draws them for int32: the bits of
    ``split(key)``'s two keys, ``hi`` and ``lo``, give
    ``minval + ((hi % span) * m + lo % span) % span`` with ``m = (2^16 %
    span)^2 % span``, every product wrapping at 32 bits."""
    lo_i = max(min(int(minval), 2 ** 31 - 1), -2 ** 31)
    hi_i = max(min(int(maxval), 2 ** 31 - 1), -2 ** 31)
    span = (hi_i - lo_i) & M32 if hi_i > lo_i else 1
    if int(maxval) > 2 ** 31 - 1 and hi_i > lo_i:
        span = (span + 1) & M32
    k1, k2 = split(key, 2)
    higher, lower = bits(k1, shape), bits(k2, shape)
    if span == 0:                 # the full 2^32 range: no reduction
        off = lower
    else:
        mult = ((2 ** 16 % span) ** 2 & M32) % span
        off = ((higher % span) * mult & M32) + lower % span
        off = (off & M32) % span
    return _to_int32(lo_i + off)


def _to_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values read modulo 2^32 as int32 (two's complement)."""
    x = x & M32
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


#: ``np.nextafter(-1, 0)`` in float32, the low end of normal's uniform
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def normal(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """float32 standard normals of ``shape``: ``sqrt(2) * erfinv(u)``,
    ``u`` uniform in ``(-1, 1)`` (jax's ``normal``)."""
    u = uniform(key, shape, _NORMAL_LO, 1.0)
    return float(np.float32(np.sqrt(2))) * torch.erfinv(u)


def tape_uniform(key: torch.Tensor, src: torch.Tensor,
                 step: torch.Tensor) -> torch.Tensor:
    """The random walk's draws, ``uniform(fold_in(fold_in(key, src[i]),
    step[i]))`` for every ``i``, in one pass (float32 ``[N]``)."""
    n = src.shape[0]
    return _ops.draw(key, n, folds=(src, step), iota=False, uniform=True)
