"""Graph I/O: edge-list / npz round-trips for CSRGraph.

A numpy copy of the JAX package's ``repro.graphs.io``.  Real deployments
feed SNAP/DIMACS-style edge lists; the npz form is the fast binary cache.
"""
from __future__ import annotations

import gzip

import numpy as np

from repro_torch.core.graph import CSRGraph


def save_npz(path: str, g: CSRGraph):
    np.savez_compressed(path, indptr=g.indptr, indices=g.indices,
                        weights=g.weights, n=np.int64(g.n),
                        m=np.int64(g.m))


def load_npz(path: str) -> CSRGraph:
    z = np.load(path)
    return CSRGraph(indptr=z["indptr"], indices=z["indices"],
                    weights=z["weights"], n=int(z["n"]), m=int(z["m"]))


def load_edge_list(path: str, *, symmetrize: bool = True,
                   weighted: bool | None = None,
                   comment: str = "#") -> CSRGraph:
    """SNAP-style whitespace edge list: ``src dst [weight]`` per line.
    Vertex ids are compacted to 0..n-1.  .gz transparently supported.

    ``weighted=None`` infers from the *whole* file: all 3-column lines
    means weighted, all 2-column means unit weights, and a mix raises.  An
    explicit ``weighted=True``/``False`` is lenient — missing third columns
    read as 1.0 / extra columns are ignored.
    """
    opener = gzip.open if path.endswith(".gz") else open
    src, dst, w = [], [], []
    arities = set()
    with opener(path, "rt") as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line or line.startswith(comment):
                continue
            parts = line.split()
            src.append(int(parts[0]))
            dst.append(int(parts[1]))
            has_w = len(parts) > 2
            arities.add(has_w)
            if weighted is None and len(arities) > 1:
                raise ValueError(
                    f"{path}:{lineno}: inconsistent edge-list arity — the "
                    f"file mixes 2-column and 3-column lines; pass "
                    f"weighted=True or weighted=False to disambiguate")
            w.append(float(parts[2]) if has_w else 1.0)
    if weighted is None:
        weighted = True in arities
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    # id compaction via sorted-search, not a dense [0, ids.max()] table —
    # SNAP dumps carry sparse 64-bit ids and a dense remap would not fit
    ids = np.unique(np.concatenate([src, dst]))
    src = np.searchsorted(ids, src)
    dst = np.searchsorted(ids, dst)
    weights = (np.asarray(w, np.float32) if weighted
               else np.ones(src.size, np.float32))
    return CSRGraph.from_edges(int(ids.size), src, dst,
                               weights, symmetrize=symmetrize)


def save_edge_list(path: str, g: CSRGraph):
    src, dst, w = g.edges()
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wt") as f:
        f.write(f"# |V|={g.n} |E|={g.m}\n")
        for s, d, ww in zip(src, dst, w):
            f.write(f"{s} {d} {ww:.6g}\n")
