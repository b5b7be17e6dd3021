"""Plain PyTorch version of the threefry draw (``csrc/threefry.cu``).

Threefry-2x32 with 20 rounds, as ``jax._src.prng`` computes it: the
rotations (13, 15, 26, 6) and (17, 29, 16, 24) in turn, a key injection
after every four rounds, and the parity constant 0x1BD11BDA.  torch has
no uint32 arithmetic, so every word is an int64 tensor holding a value in
``[0, 2^32)``, masked after each add and shift.

:func:`draw_ref` is what one launch of the kernel computes for ``n``
elements, and what the wrapper runs on a CPU tensor.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

M32 = 0xFFFFFFFF
PARITY = 0x1BD11BDA
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & M32) | (x >> (32 - r))


def threefry2x32_ref(k1, k2, x1, x2):
    """The hash of the counter pair ``(x1, x2)`` under the key ``(k1, k2)``,
    elementwise with broadcasting; every argument an int64 tensor (or int)
    of 32-bit words.  Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ PARITY)
    x0 = (x1 + ks[0]) & M32
    y = (x2 + ks[1]) & M32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + y) & M32
            y = _rotl(y, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        y = (y + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, y


def uniform_from_bits(o1: torch.Tensor, o2: torch.Tensor) -> torch.Tensor:
    """jax's float32 uniform in [0, 1) from one counter's two words: the
    top 23 bits of ``o1 ^ o2`` as the mantissa of a float in [1, 2), less
    one (then ``max(0, f * 1 + 0)``, which leaves it as it is)."""
    bits = ((o1 ^ o2) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def draw_ref(key: torch.Tensor, n: int, *, folds: Sequence[torch.Tensor] = (),
             x1: Optional[torch.Tensor] = None,
             x2: Optional[torch.Tensor] = None, iota: bool = True,
             uniform: bool = False):
    """Element ``i < n``: take the key (``key [2]``, shared, or ``key [n,
    2]``, one per element), fold in each ``folds[j][i]`` in turn
    (``fold_in``: the key becomes the hash of the counter ``(0, f)``), then
    hash the counter ``(x1[i], x2[i])``; a missing ``x1`` is 0, a missing
    ``x2`` is ``i`` under ``iota`` and 0 otherwise.  Returns the uniform
    ``[n]`` float32 under ``uniform``, else the two words ``[n]`` int64."""
    dev = key.device
    k = key.reshape(-1, 2)
    k1, k2 = k[:, 0], k[:, 1]
    for f in folds:
        k1, k2 = threefry2x32_ref(k1, k2, 0, f.to(torch.int64) & M32)
    hi = 0 if x1 is None else x1.to(torch.int64) & M32
    if x2 is not None:
        lo = x2.to(torch.int64) & M32
    elif iota:
        lo = torch.arange(n, dtype=torch.int64, device=dev)
    else:
        lo = torch.zeros(n, dtype=torch.int64, device=dev)
    o1, o2 = threefry2x32_ref(k1, k2, hi, lo)
    o1, o2 = o1.expand(n), o2.expand(n)
    if uniform:
        return uniform_from_bits(o1, o2)
    return o1.contiguous(), o2.contiguous()
