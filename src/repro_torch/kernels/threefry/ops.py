"""Wrapper of the threefry kernel (``csrc/threefry.cu``).

:func:`draw` computes what :func:`ref.draw_ref` computes: ``n`` threefry
hashes under a shared key or a key per element, after up to two
``fold_in`` words per element, as the two output words (int64 ``[n]``
each, values in ``[0, 2^32)``) or jax's float32 uniform.  ``core/prng``
builds ``fold_in``, ``split``, ``uniform`` and the random walk's tape
draw on it.

On a CUDA tensor it is one launch of ``fg_threefry`` on the current
stream, counted in :data:`LAUNCHES`; on a CPU tensor it runs the plain
version.  There is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from repro_torch.kernels import _build, count_launch
from repro_torch.kernels.contract import H100_SMS, KernelContract, TileSpec
from repro_torch.kernels.threefry.ref import draw_ref

#: kernel launches since the last :func:`reset_launches`
LAUNCHES = {"threefry": 0}

_fns: dict = {}


def reset_launches() -> None:
    LAUNCHES["threefry"] = 0


class _Args(ctypes.Structure):
    """``ThreefryArgs`` of ``csrc/threefry.cu``, field by field."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "key", "fold0", "fold1", "x1", "x2", "out1", "out2", "u")]
        + [("n", ctypes.c_longlong), ("key_stride", ctypes.c_int),
           ("iota", ctypes.c_int)])


def _kernel():
    if not _fns:
        fn = _build.library("threefry").fg_threefry
        fn.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns["launch"] = fn
    return _fns["launch"]


def load() -> None:
    """Load the kernel's library (building it if needed) and bind its
    entry point, before several threads may launch it."""
    _kernel()


def _words(t: Optional[torch.Tensor], n: int, dev, what: str):
    """``t`` as a contiguous int64 ``[n]`` on ``dev`` (or None)."""
    if t is None:
        return None
    if t.device != dev or t.dim() != 1 or t.shape[0] != n:
        raise ValueError(f"threefry: {what} must be a 1-d tensor of {n} "
                         f"words on {dev}; got {tuple(t.shape)} on "
                         f"{t.device}")
    return t.to(torch.int64).contiguous()


def draw(key: torch.Tensor, n: int, *, folds: Sequence[torch.Tensor] = (),
         x1: Optional[torch.Tensor] = None,
         x2: Optional[torch.Tensor] = None, iota: bool = True,
         uniform: bool = False):
    """See :func:`ref.draw_ref`; ``key`` is int64 ``[2]`` or ``[n, 2]``."""
    n = int(n)
    if key.dtype != torch.int64 or key.shape not in ((2,), (n, 2)):
        raise ValueError(f"threefry: key must be int64 [2] or [{n}, 2]; got "
                         f"{tuple(key.shape)} {key.dtype}")
    if len(folds) > 2:
        raise ValueError("threefry: at most two fold_in words per element")
    dev = key.device
    folds = [_words(f, n, dev, "a fold_in word") for f in folds]
    x1, x2 = _words(x1, n, dev, "x1"), _words(x2, n, dev, "x2")
    if dev.type == "cpu":
        return draw_ref(key, n, folds=folds, x1=x1, x2=x2, iota=iota,
                        uniform=uniform)
    if dev.type != "cuda":
        raise ValueError(f"threefry: no kernel for device {dev}")
    key = key.contiguous()
    if uniform:
        u = torch.empty(n, dtype=torch.float32, device=dev)
        o1 = o2 = None
    else:
        u = None
        o1 = torch.empty(n, dtype=torch.int64, device=dev)
        o2 = torch.empty(n, dtype=torch.int64, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    args = _Args(key=key.data_ptr(),
                 fold0=ptr(folds[0]) if folds else None,
                 fold1=ptr(folds[1]) if len(folds) > 1 else None,
                 x1=ptr(x1), x2=ptr(x2), out1=ptr(o1), out2=ptr(o2),
                 u=ptr(u), n=n, key_stride=0 if key.dim() == 1 else 2,
                 iota=int(iota))
    rc = _kernel()(ctypes.byref(args),
                   torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"threefry launch failed with CUDA error {rc}")
    count_launch(LAUNCHES, "threefry")
    return u if uniform else (o1, o2)


#: the static contract (kernels/contract.py) at phase 3e's 2^20 counters:
#: one element a thread, 256 threads a CTA, a grid-stride loop over at
#: most 16 CTAs an SM (csrc/threefry.cu), no shared memory
_N = 1 << 20
CONTRACTS = (KernelContract(
    name="threefry", module=__name__, kernel="threefry_kernel",
    grid=(_N // 256,), threads=256, ctas=H100_SMS * 16,
    out_tiles=(TileSpec("u", (_N,), (256,)),), wired=True),)
