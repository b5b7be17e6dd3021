"""The fused visit: one kernel launch per K-visit chunk.

``make_fused_visit(dg, algebra, max_rounds, policy=..., frontier_mode=...)``
returns a :class:`FusedVisit`, whose :meth:`FusedVisit.chunk` is the chunk
launcher of ``core/visit.make_megastep(fused=True)``: one launch of
``fg_fused_visit`` (``csrc/fused_visit.cu``) on the current stream runs the
chunk's loop on the card (select, visit, stats, up to ``launches`` times;
it stops once no partition holds a pending op), and the chunk's stats stay
on the device for the caller to read once.

The kernel runs as one thread-block cluster of :func:`cluster_size` CTAs,
each owning a slice of the query rows, and contracts over the column lists
of each block's finite entries (``DeviceGraph.col_ptr/col_u/col_w``).

On a CUDA tensor a chunk is one launch of the kernel, counted in
:data:`LAUNCHES`; on a CPU tensor it is ``ref.fused_step_ref`` once per
visit.  There is no fallback from one to the other: a failed build or
launch raises.

Each CTA asks for :func:`smem_bytes` of dynamic shared memory, the number
``fpp/planner.MemoryModel.fused_working_set`` reports; the C side refuses a
launch given less than its layout needs.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build, count_launch
from repro_torch.kernels.contract import (GRAPH_B, GRAPH_Q, KernelContract,
                                          TileSpec)
from repro_torch.kernels.fused_visit.ref import (POLICIES, FusedSpec,
                                                 fused_step_ref, new_stats)

#: kernel launches since the last :func:`reset_launches`
LAUNCHES = {"fused_visit": 0}

#: dynamic shared memory one Hopper thread block may use
MAX_SMEM_BYTES = 232_448
#: warps of one CTA (kThreads / 32 in fused_visit.cu)
_WARPS = 8
#: cluster sizes compiled into the kernel (kClusters in fused_visit.cu)
CLUSTER_SIZES = (1, 4, 8)
#: buffer sizes of fused_visit.cu: kMaxCluster, kGroup, kStageRows, kStages
_MAX_CLUSTER, _GROUP, _STAGE_ROWS, _STAGES = 8, 8, 8, 3
_ALGEBRAS = {"minplus": 0, "push": 1}

_fns: dict = {}


def reset_launches() -> None:
    LAUNCHES["fused_visit"] = 0


def cluster_size(num_queries: int) -> int:
    """CTAs per launch for ``num_queries`` query rows: one CTA up to 8
    rows, then a cluster of 4 up to 32 rows, then 8 (about 8 rows each on
    the main path's 64)."""
    if num_queries <= 8:
        return 1
    return 4 if num_queries <= 32 else 8


def smem_bytes(num_planes: int, num_queries: int, block_size: int,
               cluster: int | None = None) -> int:
    """Dynamic shared-memory bytes of one CTA: the kernel's layout
    (``layout`` in ``csrc/fused_visit.cu``) for the min-plus
    (``num_planes=1``) or the push (``num_planes=2``) algebra, at
    :func:`cluster_size` of ``num_queries`` unless ``cluster`` is given.
    It depends on (algebra, Q, B) only: the column lists stay in global
    memory and neighbour rows pass through three fixed stages."""
    c = cluster_size(num_queries) if cluster is None else cluster
    if c not in CLUSTER_SIZES:
        raise ValueError(f"cluster size {c} is not one of {CLUSTER_SIZES}")
    rows = -(-num_queries // c)
    srows = min(rows, _STAGE_ROWS)

    def r4(n):
        return -(-n // 4) * 4

    rb, sb, bw, rw = r4(rows * block_size), r4(srows * block_size), \
        r4(block_size), r4(rows)
    # reductions, exchanged and local partials, entries, mbarriers
    fixed = (8 * _WARPS + 4 + 8 * _GROUP * _MAX_CLUSTER + 6 * _GROUP + 8)
    stages = 2 * _STAGES * sb
    if num_planes == 1:
        words = 2 * rb + stages + 2 * bw + 4 * rw + fixed
        nbytes = r4(4 * words + 2 * rows * block_size) + rw
    elif num_planes == 2:
        words = 4 * rb + stages + 5 * bw + 3 * rw + fixed
        nbytes = 4 * words + rows * block_size
    else:
        raise ValueError(f"num_planes must be 1 (min-plus) or 2 (push), "
                         f"got {num_planes}")
    return -(-nbytes // 16) * 16


class _Args(ctypes.Structure):
    """``FusedArgs`` of ``csrc/fused_visit.cu``, field by field (``bulk``
    is set by the C side)."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "plane0", "plane1", "buf", "prio", "ops", "stamp", "stats",
        "col_ptr", "col_u", "col_w", "row_nnz", "nbr_blk", "nbr_dst",
        "nbr_nnz", "diag_blk", "deg", "budget", "key")]
        + [(n, ctypes.c_int) for n in (
            "P", "Q", "B", "dmax", "K", "launches", "max_rounds", "counter",
            "strict")]
        + [(n, ctypes.c_float) for n in ("window", "alpha", "c1", "eps")]
        + [("smem_bytes", ctypes.c_int), ("bulk", ctypes.c_int)])


def _library():
    if not _fns:
        lib = _build.library("fused_visit")
        fn = lib.fg_fused_visit
        i = ctypes.c_int
        fn.argtypes = [ctypes.POINTER(_Args), i, i, i, i, ctypes.c_void_p]
        fn.restype = i
        need = lib.fg_fused_visit_smem
        need.argtypes = [i, i, i, i]
        need.restype = ctypes.c_longlong
        _fns.update(launch=fn, smem=need)
    return _fns


def load() -> None:
    """Load the kernel's library (building it if needed) and bind its
    entry points, before several threads may launch it."""
    _library()


def kernel_smem_bytes(algebra: str, num_queries: int, block_size: int,
                      cluster: int | None = None) -> int:
    """The C side's own count of :func:`smem_bytes` (needs the built
    library): the two must agree."""
    c = cluster_size(num_queries) if cluster is None else cluster
    return int(_library()["smem"](_ALGEBRAS[algebra], num_queries,
                                  block_size, c))


def _validate_neighbor_lists(dg) -> None:
    """The read-modify-write emission needs every neighbour row written at
    most once per visit, and never the visited row itself.
    ``BlockGraph.from_csr`` builds unique, off-diagonal neighbour lists; a
    graph built some other way must satisfy it too."""
    P = dg.num_parts
    valid = dg.nbr_blk.cpu().numpy() >= 0
    nbr = np.where(valid, dg.nbr_dst.cpu().numpy(), -1)
    if (nbr == np.arange(P)[:, None]).any():
        raise ValueError("fused visit: the neighbour lists contain "
                         "self-edges; the visited row would be written "
                         "twice")
    s = np.sort(nbr, axis=1)
    if ((s[:, 1:] == s[:, :-1]) & (s[:, 1:] >= 0)).any():
        raise ValueError("fused visit: the neighbour lists contain "
                         "duplicate entries; the per-row read-modify-write "
                         "would apply them twice")


class FusedVisit:
    """One device graph + algebra + policy, compiled into launches."""

    def __init__(self, dg, spec: FusedSpec):
        self.dg = dg
        self.spec = spec

    @property
    def num_planes(self) -> int:
        return 1 if self.spec.algebra.name == "minplus" else 2

    def new_stats(self, state) -> torch.Tensor:
        return new_stats(state.buf.shape[1], self.dg.num_parts, self.spec.K,
                         state.buf.device)

    def ref(self, state, stats: torch.Tensor, counter: int,
            key: torch.Tensor | None = None) -> None:
        """One visit's plain version, on any device."""
        fused_step_ref(self.dg, self.spec, state, stats, counter, key=key)

    def step(self, state, stats: torch.Tensor, counter: int) -> None:
        """One visit (one launch of the kernel on a CUDA tensor, the plain
        version on a CPU tensor)."""
        self.chunk(state, counter, 1, stats=stats)

    def _check_key(self, key) -> None:
        if self.spec.policy != "random":
            return
        if (key is None or key.dtype != torch.int64 or key.shape != (2,)
                or not key.is_contiguous() or key.device != self.dg.device):
            raise ValueError(
                "fused visit: the random policy needs its threefry key, a "
                f"contiguous int64 [2] on {self.dg.device} (core/prng)")

    def _args(self, state, stats: torch.Tensor, counter: int,
              launches: int, nbytes: int, key=None) -> _Args:
        dg, sp = self.dg, self.spec
        P, (Q, B) = dg.num_parts, state.buf.shape[1:]
        tensors = (*state.planes, state.buf, state.prio, state.ops_count,
                   state.stamp, stats)
        if not all(t.is_contiguous() and t.device == dg.device
                   for t in tensors):
            raise ValueError("fused visit: the state and stats tensors must "
                             f"be contiguous and on {dg.device}")
        if (state.buf.shape != (P + 1, Q, B) or state.prio.shape != (P + 1,)
                or any(x.shape != (P, Q, B) for x in state.planes)):
            raise ValueError("fused visit: the state does not match the "
                             "device graph's partitions")
        if nbytes > MAX_SMEM_BYTES:
            raise ValueError(
                f"fused visit: Q={Q}, B={B} needs {nbytes} B of shared "
                f"memory per CTA, one block has {MAX_SMEM_BYTES}; plan a "
                f"smaller block size or fewer queries")
        planes = state.planes
        params = dict(sp.algebra.params)
        alpha = params.get("alpha", 0.0)
        return _Args(
            plane0=planes[0].data_ptr(), plane1=planes[-1].data_ptr(),
            buf=state.buf.data_ptr(), prio=state.prio.data_ptr(),
            ops=state.ops_count.data_ptr(), stamp=state.stamp.data_ptr(),
            stats=stats.data_ptr(), col_ptr=dg.col_ptr.data_ptr(),
            col_u=dg.col_u.data_ptr(), col_w=dg.col_w.data_ptr(),
            row_nnz=dg.row_nnz.data_ptr(), nbr_blk=dg.nbr_blk.data_ptr(),
            nbr_dst=dg.nbr_dst.data_ptr(), nbr_nnz=dg.nbr_nnz.data_ptr(),
            diag_blk=dg.diag_blk.data_ptr(), deg=dg.deg.data_ptr(),
            budget=dg.edge_budget.data_ptr(),
            key=None if key is None else key.data_ptr(), P=P, Q=Q, B=B,
            dmax=dg.nbr_blk.shape[1], K=sp.K,
            launches=int(launches), max_rounds=sp.max_rounds,
            counter=int(counter), strict=int(params.get("strict", 0.0)),
            window=params.get("window", 0.0), alpha=alpha,
            c1=1.0 - alpha, eps=params.get("eps", 0.0), smem_bytes=nbytes,
            bulk=0)

    def launch(self, state, stats: torch.Tensor, counter: int,
               launches: int, cluster: int,
               key: torch.Tensor | None = None) -> None:
        """One launch of the kernel as a cluster of ``cluster`` CTAs (one of
        :data:`CLUSTER_SIZES`): up to ``launches`` visits on the card.
        :meth:`chunk` picks the cluster from Q; this entry lets a
        measurement time each compiled size."""
        if state.buf.device.type != "cuda":
            raise ValueError(f"fused visit: no kernel for device "
                             f"{state.buf.device}")
        self._check_key(key)
        Q, B = state.buf.shape[1:]
        block = self._args(state, stats, counter, launches,
                           smem_bytes(self.num_planes, Q, B, cluster), key)
        rc = _library()["launch"](
            ctypes.byref(block), _ALGEBRAS[self.spec.algebra.name],
            POLICIES.index(self.spec.policy), int(self.spec.sparse),
            int(cluster),
            torch.cuda.current_stream(state.buf.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(
                "fused visit launch refused: shared memory below the "
                "layout's need" if rc == -1 else
                f"fused visit launch (cluster of {cluster}) failed with "
                f"CUDA error {rc}")
        count_launch(LAUNCHES, "fused_visit")

    def chunk(self, state, counter: int, launches: int,
              stats: torch.Tensor | None = None,
              key: torch.Tensor | None = None) -> torch.Tensor:
        """Up to ``launches`` visits (the loop stops early once no partition
        holds a pending op); returns the chunk's stats (``ref.split_stats``
        reads them).  Under the ``random`` policy ``key`` is the threefry
        key, split once per visit in place: the chunk leaves the key to
        carry into the next one there.  On the card this is one launch;
        nothing is read back here."""
        if stats is None:
            stats = self.new_stats(state)
        if state.buf.device.type == "cpu":
            self._check_key(key)
            for _ in range(launches):
                k = int(stats[0])
                self.ref(state, stats, counter, key)
                if int(stats[0]) == k:    # no pending op: the chunk is
                    break                 # complete
            return stats
        self.launch(state, stats, counter, launches,
                    cluster_size(state.buf.shape[1]), key)
        return stats


def make_fused_visit(dg, algebra, max_rounds: int, *,
                     policy: str = "priority", frontier_mode: str = "dense",
                     K: int = 64) -> FusedVisit:
    """The fused visit for one device graph and ``core.visit`` algebra.

    ``frontier_mode="sparse"`` (min-plus only) lets each contraction skip
    the query rows whose sources are all +inf: the same bits, less work on
    thin frontiers.
    """
    name = algebra.name
    if name not in _ALGEBRAS:
        raise ValueError(f"fused visit: unknown algebra {name!r}")
    if frontier_mode not in ("dense", "sparse"):
        raise ValueError(f"unknown frontier_mode {frontier_mode!r}; one of "
                         f"('dense', 'sparse')")
    if frontier_mode == "sparse" and name != "minplus":
        raise ValueError(
            "sparse frontier mode skips all-inf sources of an exact "
            "min; only the minplus algebra has that identity, push-mode ppr "
            "runs dense")
    if policy not in POLICIES:
        raise ValueError(f"fused visit: unsupported policy {policy!r}; one "
                         f"of {POLICIES}")
    _validate_neighbor_lists(dg)
    return FusedVisit(dg, FusedSpec(
        algebra=algebra, policy=policy, max_rounds=int(max_rounds),
        sparse=frontier_mode == "sparse", K=int(K)))


# ---------------------------------------------------------------------------
# static contracts (kernels/contract.py)

#: partitions of the canonical graph: the side-192 grid at B = 128
_PARTS = 192 * 192 // GRAPH_B


def _contract(algebra: str) -> KernelContract:
    Q, B, np_ = GRAPH_Q, GRAPH_B, 1 if algebra == "minplus" else 2
    c = cluster_size(Q)
    return KernelContract(
        name="fused_visit", module=__name__,
        kernel=f"fused_{'minplus' if np_ == 1 else 'push'}_kernel",
        grid=(c,), threads=_WARPS * 32, cluster=c,
        smem_bytes=smem_bytes(np_, Q, B),
        out_tiles=tuple(TileSpec(n, (_PARTS, Q, B), (1, Q, B), update="rmw")
                        for n in ("plane0", "plane1", "buf")[2 - np_:])
        + (TileSpec("stats", (2 + 2 * Q + _PARTS + 64,),
                    (2 + 2 * Q + _PARTS + 64,), update="accum"),),
        wired=True, block_size=B, num_queries=Q, fused_model=True,
        num_planes=np_, args=(("algebra", algebra), ("num_queries", Q),
                              ("block_size", B), ("cluster", c)))


CONTRACTS = (_contract("minplus"), _contract("push"))


def library_smem_bytes(c: KernelContract) -> int:
    """The built library's own count (``fg_fused_visit_smem``)."""
    return kernel_smem_bytes(c.arg("algebra"), c.arg("num_queries"),
                             c.arg("block_size"), c.arg("cluster"))
