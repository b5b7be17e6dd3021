"""Wrapper of the push kernel.

``ppr_push(p, r, acc, w, deg, alpha=..., eps=...) -> (p1, r1, acc1)``, as
the reference's ``ppr_push_pallas_call``.  On a CUDA tensor it launches
``fg_ppr_push`` (``csrc/ppr_push.cu``) on the current stream and adds one to
:data:`LAUNCHES`; on a CPU tensor it runs ``ref.push_ref``.  The engine's
path does not call it: the same round runs inside the fused visit.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, launch_site
from repro_torch.kernels.contract import (GRAPH_B, GRAPH_Q, KernelContract,
                                          TileSpec)
from repro_torch.kernels.ppr_push.ref import push_ref

#: kernel launches since the last :func:`reset_launches`
LAUNCHES = {"ppr_push": 0}

_fns: dict = {}


def reset_launches() -> None:
    LAUNCHES["ppr_push"] = 0


def _kernel():
    fn = _fns.get("ppr_push")
    if fn is None:
        fn = _build.library("ppr_push").fg_ppr_push
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, p, p, p, p, i, i, f, f, f, p]
        fn.restype = ctypes.c_int
        _fns["ppr_push"] = fn
    return fn


def _check(p, r, acc, w, deg):
    if p.dim() != 2 or not (p.shape == r.shape == acc.shape):
        raise ValueError(f"want p, r, acc [Q, B] of one shape; got "
                         f"{tuple(p.shape)}, {tuple(r.shape)}, "
                         f"{tuple(acc.shape)}")
    b = p.shape[1]
    if w.shape != (b, b):
        raise ValueError(f"w must be [{b}, {b}]; got {tuple(w.shape)}")
    if deg.numel() != b:
        raise ValueError(f"deg must hold {b} values; got {tuple(deg.shape)}")
    if any(x.dtype != torch.float32 for x in (p, r, acc, w)):
        raise ValueError("p, r, acc and w must be float32")
    if len({x.device for x in (p, r, acc, w, deg)}) != 1:
        raise ValueError("p, r, acc, w and deg must share a device")
    if not all(x.is_contiguous() for x in (p, r, acc, w)):
        raise ValueError("p, r, acc and w must be contiguous")


@launch_site("ppr_push")
def ppr_push(p: torch.Tensor, r: torch.Tensor, acc: torch.Tensor,
             w: torch.Tensor, deg: torch.Tensor, *, alpha: float,
             eps: float):
    """One push round; returns ``(p1, r1, acc1)``, each [Q, B]."""
    _check(p, r, acc, w, deg)
    degf = deg.reshape(-1).to(torch.float32).contiguous()
    if p.device.type == "cpu":
        return push_ref(p, r, acc, w, degf, alpha=alpha, eps=eps)[:3]
    if p.device.type != "cuda":
        raise ValueError(f"ppr_push: no kernel for device {p.device}")
    q, b = p.shape
    po, ro, ao = (torch.empty_like(p) for _ in range(3))
    # alpha, 1 - alpha and eps as the f32 values torch's ops use
    rc = _kernel()(p.data_ptr(), r.data_ptr(), acc.data_ptr(), w.data_ptr(),
                   degf.data_ptr(), po.data_ptr(), ro.data_ptr(),
                   ao.data_ptr(), q, b, float(alpha), 1.0 - float(alpha),
                   float(eps),
                   torch.cuda.current_stream(p.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ppr_push kernel launch failed with CUDA error "
                           f"{rc}")
    LAUNCHES["ppr_push"] += 1
    return po, ro, ao


# ---------------------------------------------------------------------------
# static contracts (kernels/contract.py)

#: csrc/ppr_push.cu: kThreads, kRows (query rows of a CTA)
_THREADS, _ROWS = 256, 16


def smem_bytes(block_size: int) -> int:
    """Dynamic shared memory of one push CTA, as ``smem_need`` in
    ``csrc/ppr_push.cu`` counts it: four ``[kRows, ld]`` float planes
    (p, r, acc, the pushed mass), three ``[ld]`` rows (degree, clamped
    degree, threshold), the block's mask bits and the active flags."""
    ld = -(-block_size // 4) * 4
    bw = (ld + 31) // 32
    return 4 * (4 * _ROWS * ld + 3 * ld) + 4 * block_size * bw + _ROWS * ld


CONTRACTS = (KernelContract(
    name="ppr_push", module=__name__, kernel="ppr_push_kernel",
    grid=(GRAPH_Q // _ROWS,), threads=_THREADS,
    smem_bytes=smem_bytes(GRAPH_B),
    out_tiles=tuple(TileSpec(n, (GRAPH_Q, GRAPH_B), (_ROWS, GRAPH_B))
                    for n in ("p", "r", "acc")),
    wired=False, block_size=GRAPH_B, num_queries=GRAPH_Q,
    args=(("block_size", GRAPH_B),),
    note="B4 runs on no path alone: its round (fg::push_cell) runs "
         "inside the fused visit (B5, csrc/fused_visit.cu); the "
         "standalone launch is held against its plain version in "
         "chip_smoke.py phase 3"),)


def library_smem_bytes(c: KernelContract) -> int:
    """The built library's own count (``fg_ppr_push_smem``)."""
    fn = _build.library("ppr_push").fg_ppr_push_smem
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_longlong
    return int(fn(c.arg("block_size")))
