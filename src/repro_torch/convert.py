"""Carry the JAX package's graph and state across into the port.

Both take numpy arrays (``np.asarray`` of the reference's jax arrays), so
this module imports neither JAX nor the reference.  The tests use them to
start both packages from identical inputs: the graph blocks and the state
planes play the part that weights play in a model port.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine import resolve_device
from repro_torch.core.graph import BlockGraph
from repro_torch.core.visit import VisitState


def block_graph_from_arrays(*, blocks, blk_src, blk_dst, nbr_blk, nbr_part,
                            diag_blk, row_nnz, deg, vmask, block_size,
                            num_parts, n, m) -> BlockGraph:
    """The reference's ``BlockGraph`` fields (as keyword arguments, e.g.
    ``**dataclasses.asdict(bg)``) as the port's ``BlockGraph``; stage it
    with ``DeviceGraph.build``."""
    return BlockGraph(
        blocks=np.asarray(blocks, np.float32),
        blk_src=np.asarray(blk_src, np.int32),
        blk_dst=np.asarray(blk_dst, np.int32),
        nbr_blk=np.asarray(nbr_blk, np.int32),
        nbr_part=np.asarray(nbr_part, np.int32),
        diag_blk=np.asarray(diag_blk, np.int32),
        row_nnz=np.asarray(row_nnz, np.int32),
        deg=np.asarray(deg, np.int32),
        vmask=np.asarray(vmask, np.bool_),
        block_size=int(block_size), num_parts=int(num_parts), n=int(n),
        m=int(m))


def state_from_arrays(planes, buf, prio, ops_count, stamp,
                      device=None) -> VisitState:
    """The reference's ``VisitState`` (planes ``[P, Q, B]`` each, ``buf
    [P+1, Q, B]``, metadata ``[P]``) as the port's, on ``device``.  The
    metadata gains the port's trash slot ``P`` (empty: +inf, 0, the empty
    stamp)."""
    dev = resolve_device(device)

    def put(a, dtype):
        return torch.from_numpy(np.array(a, dtype=dtype)).to(dev)

    buf = put(buf, np.float32)
    P = buf.shape[0] - 1
    prio, ops_count, stamp = (np.asarray(x) for x in (prio, ops_count, stamp))
    if any(x.shape != (P,) for x in (prio, ops_count, stamp)):
        raise ValueError(f"metadata must be [{P}] to match buf "
                         f"{tuple(buf.shape)}")
    empty_stamp = np.iinfo(np.int32).max - 1
    return VisitState(
        planes=tuple(put(x, np.float32) for x in planes),
        buf=buf,
        prio=put(np.append(prio, np.inf), np.float32),
        ops_count=put(np.append(ops_count, 0), np.int32),
        stamp=put(np.append(stamp, empty_stamp), np.int32))
