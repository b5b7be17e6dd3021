"""Synthetic graph generators covering the paper's dataset families.

A numpy copy of the JAX package's ``repro.graphs.generators``: the same
seeds give the same graphs in both packages.

  grid2d          road-like: 2D lattice, high diameter
  rmat            social-like: power-law R-MAT
  erdos_renyi     uniform random
  watts_strogatz  small-world (hyperlink-like)

Edge weights follow the paper: uniform in [1, log|V|).
"""
from __future__ import annotations

import os

import numpy as np

from repro_torch.core.graph import CSRGraph

#: committed edge-list fixtures (SNAP-style text, gz) live with the tests;
#: overridable so an installed package can point at its own data directory
FIXTURE_DIR = os.environ.get(
    "FPP_FIXTURE_DIR",
    os.path.join(os.path.dirname(os.path.abspath(__file__)),
                 os.pardir, os.pardir, os.pardir, "tests", "data"))


def _weights(rng: np.random.Generator, m: int, n: int) -> np.ndarray:
    hi = max(2.0, np.log(max(n, 3)))
    return rng.uniform(1.0, hi, size=m).astype(np.float32)


def grid2d(rows: int, cols: int, seed: int = 0, weighted: bool = True) -> CSRGraph:
    """Road-network-like 2D grid (4-neighborhood), symmetrized."""
    rng = np.random.default_rng(seed)
    n = rows * cols
    ids = np.arange(n).reshape(rows, cols)
    right = np.stack([ids[:, :-1].ravel(), ids[:, 1:].ravel()], axis=1)
    down = np.stack([ids[:-1, :].ravel(), ids[1:, :].ravel()], axis=1)
    e = np.concatenate([right, down], axis=0)
    w = _weights(rng, e.shape[0], n) if weighted else np.ones(e.shape[0], np.float32)
    return CSRGraph.from_edges(n, e[:, 0], e[:, 1], w, symmetrize=True)


def rmat(scale: int, edge_factor: int = 16, a: float = 0.57, b: float = 0.19,
         c: float = 0.19, seed: int = 0, weighted: bool = True,
         symmetrize: bool = True) -> CSRGraph:
    """Graph500-style R-MAT: power-law, social-network-like."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = n * edge_factor
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    ab = a + b
    for level in range(scale):
        r = rng.random(m)
        src_bit = (r >= ab).astype(np.int64)
        r2 = rng.random(m)
        thresh = np.where(src_bit == 0, a / ab, c / (1.0 - ab))
        dst_bit = (r2 >= thresh).astype(np.int64)
        src |= src_bit << level
        dst |= dst_bit << level
    # permute ids to break degree-id correlation
    perm = rng.permutation(n)
    src, dst = perm[src], perm[dst]
    w = _weights(rng, m, n) if weighted else np.ones(m, np.float32)
    return CSRGraph.from_edges(n, src, dst, w, symmetrize=symmetrize)


def erdos_renyi(n: int, avg_deg: float = 8.0, seed: int = 0,
                weighted: bool = True) -> CSRGraph:
    rng = np.random.default_rng(seed)
    m = int(n * avg_deg)
    src = rng.integers(0, n, size=m)
    dst = rng.integers(0, n, size=m)
    w = _weights(rng, m, n) if weighted else np.ones(m, np.float32)
    return CSRGraph.from_edges(n, src, dst, w, symmetrize=True)


def watts_strogatz(n: int, k: int = 8, beta: float = 0.1, seed: int = 0,
                   weighted: bool = True) -> CSRGraph:
    rng = np.random.default_rng(seed)
    base = np.arange(n, dtype=np.int64)
    srcs, dsts = [], []
    for off in range(1, k // 2 + 1):
        srcs.append(base)
        dsts.append((base + off) % n)
    src = np.concatenate(srcs)
    dst = np.concatenate(dsts)
    rewire = rng.random(src.size) < beta
    dst = np.where(rewire, rng.integers(0, n, size=src.size), dst)
    w = _weights(rng, src.size, n) if weighted else np.ones(src.size, np.float32)
    return CSRGraph.from_edges(n, src, dst, w, symmetrize=True)


def snap_fixture(name: str = "snap_tiny.txt.gz", seed: int = 0,
                 weighted: bool = True) -> CSRGraph:
    """The committed SNAP-style edge-list fixture, through the ingestion
    path (``graphs.io.load_edge_list``): sparse 64-bit vertex ids
    compacted on load, integer weights, a hub-heavy degree tail.

    ``seed`` is accepted (and ignored) only so :func:`build_suite` can
    treat the fixture like any other suite entry; ``weighted=False`` reads
    the same file with unit weights.
    """
    from repro_torch.graphs.io import load_edge_list
    path = os.path.join(FIXTURE_DIR, name)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"fixture {name} not found under {FIXTURE_DIR} — set "
            f"FPP_FIXTURE_DIR if the repo's tests/data is elsewhere")
    return load_edge_list(path, symmetrize=True, weighted=bool(weighted))


SUITES = {
    # name: (builder, kwargs) — small stand-ins for the paper's datasets
    "snap-tiny": (snap_fixture, dict()),  # committed ingested fixture (|V|=960)
    "road-ca": (grid2d, dict(rows=96, cols=96)),          # |V|=9.2k, high diameter
    "road-us": (grid2d, dict(rows=160, cols=160)),        # |V|=25.6k
    "social-lj": (rmat, dict(scale=13, edge_factor=12)),  # |V|=8.2k power law
    "social-or": (rmat, dict(scale=12, edge_factor=24)),  # denser
    "web-wk": (watts_strogatz, dict(n=8192, k=12, beta=0.2)),
    "cite-pt": (erdos_renyi, dict(n=16384, avg_deg=4.0)),
}


def build_suite(name: str, seed: int = 0, weighted: bool = True) -> CSRGraph:
    fn, kw = SUITES[name]
    return fn(seed=seed, weighted=weighted, **kw)
