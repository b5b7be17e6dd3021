"""Graph containers: host-side CSR and the block-sparse BlockGraph.

A numpy copy of the JAX package's ``repro.core.graph`` (the port imports
nothing of that package).  Vertices are reordered so each partition is a
contiguous range of ``block_size`` vertices, and the adjacency is stored as
dense ``[B, B]`` blocks for every partition pair that holds at least one
edge.  On the card one block is the tile a kernel's thread block streams
against a ``[Q, B]`` state tile; block-sparsity recovers the graph's
sparsity at partition granularity (the granularity the buffers work at).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

INF = np.float32(np.inf)


@dataclasses.dataclass
class CSRGraph:
    """Host-side CSR. ``indptr[u]:indptr[u+1]`` are out-edges of ``u``."""

    indptr: np.ndarray   # int64 [n+1]
    indices: np.ndarray  # int32 [m]
    weights: np.ndarray  # float32 [m]
    n: int
    m: int

    @staticmethod
    def from_edges(n: int, src: np.ndarray, dst: np.ndarray,
                   weights: Optional[np.ndarray] = None,
                   symmetrize: bool = False,
                   dedup: bool = True) -> "CSRGraph":
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        if weights is None:
            weights = np.ones(src.shape[0], dtype=np.float32)
        weights = np.asarray(weights, dtype=np.float32)
        if symmetrize:
            src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
            weights = np.concatenate([weights, weights])
        # drop self loops
        keep = src != dst
        src, dst, weights = src[keep], dst[keep], weights[keep]
        if dedup and src.size:
            key = src * np.int64(n) + dst
            order = np.argsort(key, kind="stable")
            key, src, dst, weights = key[order], src[order], dst[order], weights[order]
            first = np.concatenate([[True], key[1:] != key[:-1]])
            # keep the minimum weight among duplicates (groups are contiguous
            # after the stable sort)
            starts = np.flatnonzero(first)
            weights = np.minimum.reduceat(weights, starts) if starts.size else weights
            src, dst = src[first], dst[first]
        order = np.argsort(src, kind="stable")
        src, dst, weights = src[order], dst[order], weights[order]
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.add.at(indptr, src + 1, 1)
        indptr = np.cumsum(indptr)
        return CSRGraph(indptr=indptr, indices=dst.astype(np.int32),
                        weights=weights.astype(np.float32), n=n, m=int(dst.size))

    def out_degree(self) -> np.ndarray:
        return np.diff(self.indptr).astype(np.int32)

    def permute(self, perm: np.ndarray) -> "CSRGraph":
        """Relabel vertices: new id of old vertex v is ``perm[v]``."""
        src = np.repeat(np.arange(self.n, dtype=np.int64), np.diff(self.indptr))
        return CSRGraph.from_edges(self.n, perm[src], perm[self.indices],
                                   self.weights, dedup=False)

    def edges(self):
        src = np.repeat(np.arange(self.n, dtype=np.int64), np.diff(self.indptr))
        return src, self.indices.astype(np.int64), self.weights


@dataclasses.dataclass
class BlockGraph:
    """Block-sparse dense-block adjacency over contiguous vertex partitions.

    Vertices are assumed already reordered (see partition.py) so that partition
    ``p`` owns vertices ``[p*B, (p+1)*B)`` of the padded id space.

    blocks      float32 [nblk, B, B]  blocks[k][u_loc, v_loc] = w(u, v), +inf absent
    blk_src     int32   [nblk]        source partition of block k
    blk_dst     int32   [nblk]        destination partition of block k
    nbr_blk     int32   [P, Dmax]     block ids of partition p's out-blocks (-1 pad),
                                      EXCLUDING the diagonal block
    nbr_part    int32   [P, Dmax]     destination partition per entry (-1 pad);
                                      the real entries of a row are distinct
    diag_blk    int32   [P]           block id of (p, p); always present
    row_nnz     int32   [nblk, B]     out-degree of each local row within block k
    deg         int32   [P, B]        total out-degree of each vertex (padded: 0)
    vmask       bool    [P, B]        True for real (non padding) vertices
    """

    blocks: np.ndarray
    blk_src: np.ndarray
    blk_dst: np.ndarray
    nbr_blk: np.ndarray
    nbr_part: np.ndarray
    diag_blk: np.ndarray
    row_nnz: np.ndarray
    deg: np.ndarray
    vmask: np.ndarray
    block_size: int
    num_parts: int
    n: int                 # real vertex count (pre-padding)
    m: int

    @property
    def n_padded(self) -> int:
        return self.num_parts * self.block_size

    @staticmethod
    def from_csr(g: CSRGraph, block_size: int) -> "BlockGraph":
        B = int(block_size)
        P = max(1, -(-g.n // B))
        n_pad = P * B
        src, dst, w = g.edges()
        psrc = (src // B).astype(np.int64)
        pdst = (dst // B).astype(np.int64)
        pair = psrc * P + pdst
        # block ids for every (psrc, pdst) pair that appears, plus all diagonals
        diag_pairs = np.arange(P, dtype=np.int64) * P + np.arange(P, dtype=np.int64)
        uniq = np.unique(np.concatenate([pair, diag_pairs]))
        nblk = int(uniq.size)
        pair_to_blk = {int(pv): k for k, pv in enumerate(uniq)}
        blk_src = (uniq // P).astype(np.int32)
        blk_dst = (uniq % P).astype(np.int32)
        blocks = np.full((nblk, B, B), INF, dtype=np.float32)
        if src.size:
            bk = np.array([pair_to_blk[int(pv)] for pv in pair], dtype=np.int64)
            ul = (src % B).astype(np.int64)
            vl = (dst % B).astype(np.int64)
            # duplicate edges already removed in CSR; direct assignment keeps min
            flat = blocks.reshape(nblk, B * B)
            np.minimum.at(flat, (bk, ul * B + vl), w.astype(np.float32))
        diag_blk = np.array([pair_to_blk[int(p * P + p)] for p in range(P)],
                            dtype=np.int32)
        # neighbor lists excluding the diagonal
        nbrs: list[list[int]] = [[] for _ in range(P)]
        for k in range(nblk):
            if blk_src[k] != blk_dst[k]:
                nbrs[int(blk_src[k])].append(k)
        dmax = max(1, max((len(x) for x in nbrs), default=1))
        nbr_blk = np.full((P, dmax), -1, dtype=np.int32)
        nbr_part = np.full((P, dmax), -1, dtype=np.int32)
        for p in range(P):
            for j, k in enumerate(nbrs[p]):
                nbr_blk[p, j] = k
                nbr_part[p, j] = blk_dst[k]
        row_nnz = np.isfinite(blocks).sum(axis=2).astype(np.int32)
        deg = np.zeros((P, B), dtype=np.int32)
        full_deg = np.zeros(n_pad, dtype=np.int64)
        np.add.at(full_deg, src, 1)
        deg[:, :] = full_deg.reshape(P, B)
        vmask = (np.arange(n_pad).reshape(P, B) < g.n)
        return BlockGraph(blocks=blocks, blk_src=blk_src, blk_dst=blk_dst,
                          nbr_blk=nbr_blk, nbr_part=nbr_part, diag_blk=diag_blk,
                          row_nnz=row_nnz, deg=deg, vmask=vmask,
                          block_size=B, num_parts=P, n=g.n, m=g.m)

    def nbytes(self) -> int:
        return sum(a.nbytes for a in
                   (self.blocks, self.nbr_blk, self.nbr_part, self.diag_blk,
                    self.row_nnz, self.deg, self.vmask))

    def part_of(self, v: int) -> int:
        return int(v) // self.block_size

    def local_of(self, v: int) -> int:
        return int(v) % self.block_size
