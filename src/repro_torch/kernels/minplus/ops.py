"""Wrappers of the contraction kernels: one entry per kernel, batched.

``minplus(x, blocks, idx, lists)`` and ``masked_matmul(x, blocks, idx,
lists)`` take a state tile ``x [Q, B]``, the graph's dense blocks ``[nblk,
B, B]`` (or None on the card), block indices ``idx [S]`` (int64) and the
blocks as column lists ``lists = (col_ptr [nblk, B+1] int32, col_u [nnz]
int32, col_w [nnz] float32)`` (``core/engine.column_lists``;
``DeviceGraph.lists``), and return ``[S, Q, B]``: the contraction of ``x``
with block ``idx[s]``, or the identity plane (+inf / 0) where ``idx[s] <
0``.  The visit's relax is ``S = 1``; its emission is one call over the
partition's neighbour list.

The gathered form, ``xrow=`` an int64 ``[S]``: ``x`` is ``[X, Q, B]`` and
block ``idx[s]`` contracts ``x[xrow[s]]``.  A baselines round is one such
call over every block of the graph (``xrow = blk_src``).  On the card an
``xrow`` outside ``[0, X)`` gives a NaN plane, as an index past nblk does;
on the CPU :func:`_check` rejects it (a range test on the card would read
the device back, which a CUDA graph's capture does not allow).

On a CUDA tensor a wrapper launches its hand-written kernel
(``csrc/minplus.cu``), which walks the lists, on the current stream and
adds one to its count in :data:`LAUNCHES`; the dense blocks are not read
and may be None.  On a CPU tensor it runs the plain version on the dense
``blocks`` (:func:`plain`), which it then needs, and counts nothing.
There is no fallback from one to the other.

The masked matmul's ``x`` must be finite (both callers' payloads are: the
pushed mass and the accumulated emission).  On a non-finite ``x`` the dense
plain version turns ``inf * 0`` into NaN in every column and the kernel's
list walk does not.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, count_launch, launch_site
from repro_torch.kernels.contract import (GRAPH_B, GRAPH_Q, KernelContract,
                                          TileSpec)
from repro_torch.kernels.minplus.ref import masked_matmul_ref, minplus_ref

#: kernel launches per wrapper since the last :func:`reset_launches`
LAUNCHES = {"minplus": 0, "masked_matmul": 0}

#: s-slices one launch of the ungathered form takes (gridDim.z); past it
#: the wrapper runs the gathered form, whose CTAs loop over s
MAX_GRID_Z = 65_535

_SYMBOLS = {"minplus": "fg_minplus", "masked_matmul": "fg_masked_matmul"}
_fns: dict = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.library("minplus"), _SYMBOLS[name])
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, ll, ll, ll, p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def load() -> None:
    """Load the library (building it if needed) and bind both entry
    points, before several threads may launch them."""
    for name in _SYMBOLS:
        _kernel(name)


def _check(x: torch.Tensor, blocks: Optional[torch.Tensor],
           idx: torch.Tensor, lists,
           xrow: Optional[torch.Tensor] = None) -> None:
    want_dim, form = (2, "[Q, B]") if xrow is None else (3, "[X, Q, B]")
    if x.dim() != want_dim or x.dtype != torch.float32:
        raise ValueError(f"x must be a float32 {form}; got "
                         f"{tuple(x.shape)} {x.dtype}")
    b = x.shape[-1]
    if idx.dim() != 1 or idx.dtype != torch.int64:
        raise ValueError(f"idx must be a 1-d int64 tensor; got "
                         f"{tuple(idx.shape)} {idx.dtype}")
    if xrow is not None:
        if xrow.dtype != torch.int64 or xrow.shape != idx.shape:
            raise ValueError(f"xrow must be int64 {tuple(idx.shape)} like "
                             f"idx; got {tuple(xrow.shape)} {xrow.dtype}")
        if xrow.device.type == "cpu" and xrow.numel() and bool(
                ((xrow < 0) | (xrow >= x.shape[0])).any()):
            raise ValueError(f"xrow must lie in [0, {x.shape[0]}) (x's "
                             f"rows); got {xrow.min()}..{xrow.max()}")
    if len(lists) != 3:
        raise ValueError("lists must be (col_ptr, col_u, col_w)")
    col_ptr, col_u, col_w = lists
    if (col_ptr.dtype, col_u.dtype, col_w.dtype) != (
            torch.int32, torch.int32, torch.float32):
        raise ValueError(f"lists must be int32, int32 and float32; got "
                         f"{col_ptr.dtype}, {col_u.dtype} and {col_w.dtype}")
    if col_ptr.dim() != 2 or col_ptr.shape[1] != b + 1:
        raise ValueError(f"col_ptr must be [nblk, B+1] with B = {b} from x; "
                         f"got {tuple(col_ptr.shape)}")
    if col_u.dim() != 1 or col_u.shape != col_w.shape:
        raise ValueError(f"col_u and col_w must be [nnz] each; got "
                         f"{tuple(col_u.shape)} and {tuple(col_w.shape)}")
    tensors = [x, idx, col_ptr, col_u, col_w]
    if xrow is not None:
        tensors.append(xrow)
    if blocks is None:
        if x.device.type == "cpu":
            raise ValueError("the CPU path contracts the dense blocks; "
                             "pass them")
    else:
        want = (col_ptr.shape[0], b, b)
        if blocks.shape != want or blocks.dtype != torch.float32:
            raise ValueError(f"blocks must be float32 [nblk, B, B] = {want} "
                             f"to match the lists; got "
                             f"{tuple(blocks.shape)} {blocks.dtype}")
        tensors.append(blocks)
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"x, idx, xrow, the lists and blocks must share "
                         f"a device; got {[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("x, idx, xrow, the lists and blocks must be "
                         "contiguous")


def plain(name: str, x: torch.Tensor, blocks: torch.Tensor,
          idx: torch.Tensor,
          xrow: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain PyTorch version of kernel ``name``'s batched entry (and of
    its gathered form, ``xrow``), on the dense blocks, on any device: what
    the CPU path runs and what the kernels are held against."""
    if xrow is not None:
        # one slice per distinct row of x, each the ungathered entry on the
        # blocks that read that row
        out = torch.empty((idx.shape[0], *x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        for r in torch.unique(xrow).tolist():
            sel = torch.nonzero(xrow == r).squeeze(1)
            out[sel] = plain(name, x[r], blocks, idx.index_select(0, sel))
        return out
    w = blocks.index_select(0, idx.clamp(min=0))
    if name == "minplus":
        out, ident = minplus_ref(x, w), float("inf")
    else:
        out, ident = masked_matmul_ref(x, w), 0.0
    return torch.where((idx >= 0)[:, None, None], out, ident)


def _run(name: str, x, blocks, idx, lists, xrow=None) -> torch.Tensor:
    _check(x, blocks, idx, lists, xrow)
    if x.device.type == "cpu":
        return plain(name, x, blocks, idx, xrow)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: tensors on {x.device} but the current "
                         f"device is cuda:{torch.cuda.current_device()}")
    fn = _kernel(name)
    col_ptr, col_u, col_w = lists
    (q, b), s = x.shape[-2:], idx.shape[0]
    if xrow is None and s > MAX_GRID_Z:
        x, xrow = x[None], torch.zeros_like(idx)
    out = torch.empty((s, q, b), dtype=x.dtype, device=x.device)
    rc = fn(x.data_ptr(), None if xrow is None else xrow.data_ptr(),
            idx.data_ptr(), col_ptr.data_ptr(), col_u.data_ptr(),
            col_w.data_ptr(), out.data_ptr(), s, q, b,
            1 if xrow is None else x.shape[0], col_ptr.shape[0],
            col_u.shape[0], torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error "
                           f"{rc}")
    count_launch(LAUNCHES, name)
    return out


@launch_site("minplus")
def minplus(x: torch.Tensor, blocks: Optional[torch.Tensor],
            idx: torch.Tensor, lists,
            xrow: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[s, q, v] = min_u x[q, u] + blocks[idx[s], u, v]`` (``x`` read
    as ``x[xrow[s]]`` in the gathered form)."""
    return _run("minplus", x, blocks, idx, lists, xrow)


@launch_site("masked_matmul")
def masked_matmul(x: torch.Tensor, blocks: Optional[torch.Tensor],
                  idx: torch.Tensor, lists,
                  xrow: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[s] = x @ isfinite(blocks[idx[s]])``, for finite ``x`` (read as
    ``x[xrow[s]]`` in the gathered form)."""
    return _run("masked_matmul", x, blocks, idx, lists, xrow)


# ---------------------------------------------------------------------------
# static contracts (kernels/contract.py)

#: csrc/minplus.cu: kCols (output columns of a CTA), kRows (query rows of
#: a CTA: kWarps x kWarpRows), kThreads, kSegCap
_COLS, _ROWS, _THREADS, _SEG_CAP = 32, 8, 128, 4096


def smem_bytes(minplus: bool, block_size: int, nnz: int) -> int:
    """Dynamic shared memory of one list-contraction CTA, as
    ``csrc/minplus.cu`` counts it (``seg_cap`` and ``smem_of``): ``kRows``
    rows of x, then the staged segment's rows (and weights, for min-plus)
    of at most ``kSegCap`` entries, one padding word per 128."""
    cap = -(-nnz // _COLS) * _COLS if nnz < _SEG_CAP else _SEG_CAP
    slots = cap + (cap >> 7)
    return 4 * (_ROWS * block_size + slots * (2 if minplus else 1))


def _contract(name: str, S: int, gathered: bool) -> KernelContract:
    Q, B = GRAPH_Q, GRAPH_B
    nnz = 1 << 20        # lists longer than a segment: the largest CTA
    return KernelContract(
        name="minplus", module=__name__,
        kernel=(f"list_contract_kernel<{str(name == 'minplus').lower()}, "
                f"{str(gathered).lower()}>"),
        grid=(B // _COLS, Q // _ROWS, S), threads=_THREADS,
        smem_bytes=smem_bytes(name == "minplus", B, nnz),
        out_tiles=(TileSpec("out", (S, Q, B), (1, _ROWS, _COLS)),),
        wired=True, block_size=B, num_queries=Q,
        args=(("minplus", int(name == "minplus")), ("block_size", B),
              ("nnz", nnz)))


#: the visit's relax (one block) and a baselines round's gathered form
#: (every block of the side-192 grid, S = 1,182)
CONTRACTS = tuple(_contract(name, S, gathered)
                  for name in ("minplus", "masked_matmul")
                  for S, gathered in ((1, False), (1182, True)))


def library_smem_bytes(c: KernelContract) -> int:
    """The built library's own count of ``c``'s shared memory
    (``fg_minplus_smem``)."""
    fn = _build.library("minplus").fg_minplus_smem
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_longlong]
    fn.restype = ctypes.c_longlong
    return int(fn(c.arg("minplus"), c.arg("block_size"), c.arg("nnz")))
