"""The port's threefry stream: jax's ``jax.random`` keys, bit for bit.

The JAX package draws every random number it needs from threefry-2x32
keys: the ``random`` scheduling policy (a key split once per visit) and
the random walk's tape (``uniform(fold_in(fold_in(PRNGKey(seed), src),
t))``).  The port reproduces those bits exactly, in jax's default mode
(``jax_threefry_partitionable`` on, 64-bit types off):

* ``PRNGKey(s)`` is ``[0, s mod 2^32]`` (the seed is read as 32 bits);
* ``fold_in(k, d)`` is the hash of the counter ``(0, d)`` under ``k``;
* ``split(k, num)``: new key ``i`` is the hash of the counter ``(0, i)``;
* ``uniform(k, shape)``: element ``i`` (row-major) takes ``o1 ^ o2`` of
  the counter ``(0, i)``, its top 23 bits the mantissa of a float in
  [1, 2), less one.

A key is an int64 tensor ``[2]`` holding two 32-bit words (torch has no
uint32 arithmetic); a batch of keys is ``[N, 2]``.  Every function works
on the key's device: on the CPU the plain version
(``kernels/threefry/ref.py``), on the card one launch of the threefry
kernel (``kernels/threefry/ops.py``).
"""
from __future__ import annotations

import math
from typing import Sequence, Union

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


def uniform(key: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """float32 uniforms in [0, 1): of ``shape`` under one key ``[2]``, or
    one per key of ``[N, 2]`` (``shape`` must then be ``()``: the
    vmapped ``jax.random.uniform(key)``)."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    if key.dim() == 2:
        if shape:
            raise ValueError("uniform over a batch of keys draws one value "
                             "per key; pass shape=()")
        return _ops.draw(key, key.shape[0], iota=False, uniform=True)
    return _ops.draw(key, math.prod(shape), uniform=True).reshape(shape)


def tape_uniform(key: torch.Tensor, src: torch.Tensor,
                 step: torch.Tensor) -> torch.Tensor:
    """The random walk's draws, ``uniform(fold_in(fold_in(key, src[i]),
    step[i]))`` for every ``i``, in one pass (float32 ``[N]``)."""
    n = src.shape[0]
    return _ops.draw(key, n, folds=(src, step), iota=False, uniform=True)
