"""Wrapper of the frontier kernel.

``frontier(buf, dist, delta=...) -> (d1, srcs, prio_rows)``, as the
reference's ``frontier_pallas_call``.  On a CUDA tensor it launches
``fg_frontier`` (``csrc/frontier.cu``) on the current stream and adds one
to :data:`LAUNCHES`; on a CPU tensor it runs ``ref.frontier_ref``.  The
engine's path does not call it: the same tile runs inside the fused visit.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, launch_site
from repro_torch.kernels.contract import (GRAPH_B, GRAPH_Q, KernelContract,
                                          TileSpec)
from repro_torch.kernels.frontier.ref import frontier_ref

#: kernel launches since the last :func:`reset_launches`
LAUNCHES = {"frontier": 0}

_fns: dict = {}


def reset_launches() -> None:
    LAUNCHES["frontier"] = 0


def _kernel():
    fn = _fns.get("frontier")
    if fn is None:
        fn = _build.library("frontier").fg_frontier
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
        _fns["frontier"] = fn
    return fn


def _check(buf: torch.Tensor, dist: torch.Tensor):
    if buf.dim() != 2 or buf.shape != dist.shape:
        raise ValueError(f"want buf and dist [Q, B] of one shape; got "
                         f"{tuple(buf.shape)} and {tuple(dist.shape)}")
    if buf.dtype != torch.float32 or dist.dtype != torch.float32:
        raise ValueError(f"buf and dist must be float32; got {buf.dtype} "
                         f"and {dist.dtype}")
    if buf.device != dist.device:
        raise ValueError(f"buf and dist must share a device; got "
                         f"{buf.device} and {dist.device}")
    if not (buf.is_contiguous() and dist.is_contiguous()):
        raise ValueError("buf and dist must be contiguous")


@launch_site("frontier")
def frontier(buf: torch.Tensor, dist: torch.Tensor, *, delta: float,
             strict: bool = False):
    """buf, dist: [Q, B] -> ``(d1 [Q, B], srcs [Q, B], prio_rows [Q])``."""
    _check(buf, dist)
    if buf.device.type == "cpu":
        d1, srcs, alpha, _, _ = frontier_ref(buf, dist, delta=delta,
                                             strict=strict)
        return d1, srcs, alpha[:, 0]
    if buf.device.type != "cuda":
        raise ValueError(f"frontier: no kernel for device {buf.device}")
    q, b = buf.shape
    d1, srcs = torch.empty_like(buf), torch.empty_like(buf)
    prio = torch.empty(q, dtype=buf.dtype, device=buf.device)
    rc = _kernel()(buf.data_ptr(), dist.data_ptr(), d1.data_ptr(),
                   srcs.data_ptr(), prio.data_ptr(), q, b, float(delta),
                   int(strict),
                   torch.cuda.current_stream(buf.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"frontier kernel launch failed with CUDA error "
                           f"{rc}")
    LAUNCHES["frontier"] += 1
    return d1, srcs, prio


#: the static contract (kernels/contract.py): one warp a query row, 8 rows
#: a CTA (kWarps in csrc/frontier.cu), no dynamic shared memory
CONTRACTS = (KernelContract(
    name="frontier", module=__name__, kernel="frontier_kernel",
    grid=(GRAPH_Q // 8,), threads=256,
    out_tiles=(TileSpec("d1", (GRAPH_Q, GRAPH_B), (8, GRAPH_B)),
               TileSpec("srcs", (GRAPH_Q, GRAPH_B), (8, GRAPH_B)),
               TileSpec("prio", (GRAPH_Q,), (8,))),
    wired=False, block_size=GRAPH_B, num_queries=GRAPH_Q,
    note="B3 runs on no path alone: its tile (fg::frontier_row) runs "
         "inside the fused visit (B5, csrc/fused_visit.cu); the "
         "standalone launch is held against its plain version in "
         "chip_smoke.py phase 3"),)
