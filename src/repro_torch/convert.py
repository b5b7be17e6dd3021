"""Carry the JAX package's graph, state and LM weights across into the port.

Every function takes numpy arrays (``np.asarray`` of the reference's jax
arrays), so this module imports neither JAX nor the reference.  The tests
use them to start both packages from identical inputs: the graph blocks and
the state planes play the part that weights play in a model port,
``lm_params_from_arrays`` carries the weights themselves and
``train_state_from_arrays`` a whole training state.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
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


def lm_params_from_arrays(tree: dict, cfg: ArchConfig, device=None,
                          rules=None) -> dict:
    """The reference's LM params (``jax.tree.map(np.asarray, params)`` of
    ``Model.init``: nested dicts, the ``stack`` leaves ``[L, ...]``, a moe
    layer's ``router`` and experts among them; the
    hybrid's ``groups`` of ``rec1``, ``rec2`` and ``attn`` layers ``[L/3,
    ...]`` and its recurrent ``tail``; encdec's ``encoder`` and ``decoder``
    stacks, a decoder layer's ``ln_x`` and ``xattn``, its ``enc_norm``) as
    the port's, on ``device``, each leaf in its storage dtype
    (``models.transformer.storage_dtype``: the recurrences' ``_KEEP_F32``
    leaves in float32, every norm in ``pdtype``).  With ``rules`` (over a
    ``launch/mesh.Mesh``) each leaf is this rank's block of it, cut by
    ``Model.param_axes()`` (``sharding.local_shard``) before it goes to
    ``device``."""
    from repro_torch.models.factory import build_model
    from repro_torch.models.sharding import local_shard
    from repro_torch.models.transformer import storage_dtype

    dev = resolve_device(device)
    axes = build_model(cfg).param_axes() if rules is not None else None

    def put(node, path, ax):
        if isinstance(node, dict):
            return {k: put(v, path + (k,), None if ax is None else ax[k])
                    for k, v in node.items()}
        t = torch.from_numpy(np.array(node, dtype=np.float32))
        if ax is not None:
            t = local_shard(t, ax, rules)
        return t.to(device=dev, dtype=storage_dtype(path, cfg))

    return put(tree, (), axes)


def _tensor(a, dev) -> torch.Tensor:
    """A numpy leaf as a tensor of its own dtype (bfloat16, which numpy
    holds as ``ml_dtypes``'s, through float32: exact)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=dev, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(dev)


def train_state_from_arrays(*, params, mu, nu, count, step, master=None,
                            ef=None, device=None, cfg=None, rules=None):
    """The reference's ``TrainState`` (``jax.tree.map(np.asarray, ...)`` of
    its ``params``, ``opt.mu``, ``opt.nu``, ``opt.count``, ``opt.master``,
    ``ef`` and ``step``) as the port's ``train_step.TrainState`` on
    ``device``, every leaf in its own dtype (the reference trains float32
    parameters; its ``count`` and ``step`` are int32).  With ``rules``
    (over a ``launch/mesh.Mesh``) and ``cfg``, each leaf is this rank's
    block of it by ``train_step.state_shardings`` (cut on the host before
    it goes to ``device``)."""
    from repro_torch.models.factory import build_model
    from repro_torch.train.optimizer import AdamState
    from repro_torch.train.train_step import TrainState, state_shardings

    dev = resolve_device(device)
    cpu = torch.device("cpu")

    def put(node, d):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: put(v, d) for k, v in node.items()}
        return _tensor(node, d)

    opt = AdamState(mu=put(mu, cpu), nu=put(nu, cpu), count=put(count, dev),
                    master=put(master, cpu))
    state = TrainState(params=put(params, cpu), opt=opt, step=put(step, dev),
                       ef=put(ef, cpu))
    if rules is not None:
        from repro_torch.train.train_step import shard_state
        if cfg is None:
            raise ValueError("a sharded train state needs the cfg whose "
                             "param axes cut it")
        specs = state_shardings(state, build_model(cfg).param_axes(), rules)
        state = shard_state(state, specs, rules.mesh)
    return _to(state, dev)


def _to(tree, dev):
    """Every tensor leaf of a tree of dicts and NamedTuples on ``dev``."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return type(tree)(*(_to(v, dev) for v in tree))
