"""Int8 gradient compression with error feedback.

The port of the JAX package's ``repro.train.compress``:
``compress_with_error_feedback`` quantizes each gradient leaf to symmetric
per-tensor int8 and back, carrying the quantization residual into an
error-feedback buffer (Seide et al. / 1-bit-SGD style EF).  It simulates
the wire format bit for bit; the train step applies it where the
gradient all-reduce would be.  On a mesh each rank holds shards of every
leaf, and a leaf's scale comes from its largest entry over every shard
(one max over the mesh for all leaves: a leaf's replicas hold equal
values), so each rank quantizes its shard as the reference quantizes the
whole leaf.

``compressed_psum`` is the collective for real meshes: a sum over a mesh
axis whose payloads are int8 values under one shared scale, summed as
int32 (int8 would overflow past 127 ranks) and dequantized after.
"""
from __future__ import annotations

import torch

from repro_torch.train.optimizer import tree_leaves, tree_map


def quantize_int8(x: torch.Tensor, amax: torch.Tensor = None):
    """Symmetric per-tensor int8.  Returns (q int8, scale float32 0-d).
    ``amax``, the largest ``|x|`` (of the whole leaf, where ``x`` is a
    shard of it), is computed from ``x`` when not given."""
    xf = x.float()
    if amax is None:
        amax = xf.abs().max()
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_with_error_feedback(grads: dict, ef: dict, mesh=None):
    """grads, ef: congruent trees of tensors (ef float32).  Returns
    (decompressed grads in each leaf's dtype, new ef).  With a ``mesh``
    whose ranks hold shards of the leaves, each leaf's scale is its
    largest entry over every rank (module docstring)."""
    def one(g, e, a=None):
        gf = g.float() + e
        q, scale = quantize_int8(gf, a)
        deq = dequantize_int8(q, scale)
        return deq.to(g.dtype), gf - deq
    if mesh is not None and mesh.distributed:
        local = torch.stack([(g.float() + e).abs().max() for g, e in zip(
            tree_leaves(grads), tree_leaves(ef))])
        # in tree_leaves' (sorted-key) order, as ``local`` was stacked
        amax = _keyed(grads, iter(mesh.all_reduce_max(local).unbind(0)))
        out = tree_map(one, grads, ef, amax)
    else:
        out = tree_map(one, grads, ef)
    return tree_map(lambda t: t[0], out), tree_map(lambda t: t[1], out)


def _keyed(tree, it):
    """A tree congruent with ``tree`` whose leaves are taken from ``it`` in
    sorted-key order (``optimizer.tree_leaves``)."""
    if isinstance(tree, dict):
        out = {k: _keyed(tree[k], it) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    return next(it)


def compressed_psum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum of ``x`` over ``axis`` of ``mesh`` with an int8 wire format:
    one scale shared by the ranks (the max over the axis of each rank's
    largest ``|x|``), each rank's int8 payload, their int32 sum, then
    dequantized (float32, the same on every rank of the axis)."""
    xf = x.float()
    amax = mesh.all_reduce_max(torch.clamp(xf.abs().max(), min=1e-12), axis)
    scale = amax / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int32)
    return mesh.all_reduce_sum(q, axis).float() * scale
