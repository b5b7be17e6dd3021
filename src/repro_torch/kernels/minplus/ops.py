"""Wrappers of the contraction kernels: one entry per kernel, batched.

``minplus(x, blocks, idx)`` and ``masked_matmul(x, blocks, idx)`` take a
state tile ``x [Q, B]``, the graph's blocks ``[nblk, B, B]`` and block
indices ``idx [S]`` (int64), and return ``[S, Q, B]``: the contraction of
``x`` with ``blocks[idx[s]]``, or the identity plane (+inf / 0) where
``idx[s] < 0``.  The visit's relax is ``S = 1``; its emission is one call
over the partition's neighbour list.

On a CUDA tensor a wrapper launches its hand-written kernel
(``csrc/minplus.cu``) on the current stream and adds one to its count in
:data:`LAUNCHES`; on a CPU tensor it runs the plain version in ``ref`` and
counts nothing.  There is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.minplus.ref import masked_matmul_ref, minplus_ref

#: kernel launches per wrapper since the last :func:`reset_launches`
LAUNCHES = {"minplus": 0, "masked_matmul": 0}

_SYMBOLS = {"minplus": "fg_minplus", "masked_matmul": "fg_masked_matmul"}
_fns: dict = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.library("minplus"), _SYMBOLS[name])
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, ctypes.c_longlong, p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check(x: torch.Tensor, blocks: torch.Tensor, idx: torch.Tensor):
    if x.dim() != 2 or blocks.dim() != 3:
        raise ValueError(f"want x [Q, B] and blocks [nblk, B, B]; got "
                         f"{tuple(x.shape)} and {tuple(blocks.shape)}")
    b = x.shape[1]
    if blocks.shape[1:] != (b, b):
        raise ValueError(f"blocks must be [nblk, {b}, {b}] to match x "
                         f"{tuple(x.shape)}; got {tuple(blocks.shape)}")
    if idx.dim() != 1 or idx.dtype != torch.int64:
        raise ValueError(f"idx must be a 1-d int64 tensor; got "
                         f"{tuple(idx.shape)} {idx.dtype}")
    if x.dtype != torch.float32 or blocks.dtype != torch.float32:
        raise ValueError(f"x and blocks must be float32; got {x.dtype} and "
                         f"{blocks.dtype}")
    if not (x.device == blocks.device == idx.device):
        raise ValueError(f"x, blocks and idx must share a device; got "
                         f"{x.device}, {blocks.device}, {idx.device}")
    if not (x.is_contiguous() and blocks.is_contiguous()
            and idx.is_contiguous()):
        raise ValueError("x, blocks and idx must be contiguous")


def plain(name: str, x: torch.Tensor, blocks: torch.Tensor,
          idx: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of kernel ``name``'s batched entry, on any
    device: what the CPU path runs and what the kernels are held against."""
    w = blocks.index_select(0, idx.clamp(min=0))
    if name == "minplus":
        out, ident = minplus_ref(x, w), float("inf")
    else:
        out, ident = masked_matmul_ref(x, w), 0.0
    return torch.where((idx >= 0)[:, None, None], out, ident)


def _run(name: str, x, blocks, idx) -> torch.Tensor:
    _check(x, blocks, idx)
    if x.device.type == "cpu":
        return plain(name, x, blocks, idx)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: tensors on {x.device} but the current "
                         f"device is cuda:{torch.cuda.current_device()}")
    fn = _kernel(name)
    (q, b), s = x.shape, idx.shape[0]
    out = torch.empty((s, q, b), dtype=x.dtype, device=x.device)
    rc = fn(x.data_ptr(), blocks.data_ptr(), idx.data_ptr(), out.data_ptr(),
            s, q, b, blocks.shape[0],
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error "
                           f"{rc}")
    LAUNCHES[name] += 1
    return out


def minplus(x: torch.Tensor, blocks: torch.Tensor, idx: torch.Tensor
            ) -> torch.Tensor:
    """``out[s, q, v] = min_u x[q, u] + blocks[idx[s], u, v]``."""
    return _run("minplus", x, blocks, idx)


def masked_matmul(x: torch.Tensor, blocks: torch.Tensor, idx: torch.Tensor
                  ) -> torch.Tensor:
    """``out[s] = x @ isfinite(blocks[idx[s]])``."""
    return _run("masked_matmul", x, blocks, idx)
