"""AdamW and its learning-rate schedules.

The port of the JAX package's ``repro.train.optimizer``, with its maths and
defaults: b1 0.9, b2 0.95, eps 1e-8, weight decay 0.01 and a global-norm
clip of 1.0 applied as a scale inside the update (the reference's fused
clip), with float32 master weights when a parameter is not float32.

The optimizer state is a tree congruent with the parameters.  The update
is written in place, leaf by leaf, over flat chunks of at most
``CHUNK`` elements: its transient memory is a few chunks, not copies of
the largest leaf (a ``[L, 4608, 18432]`` MLP stack is 4 GB in float32 at
L = 12).  Each element sees the reference's operations in the
reference's order; ``add_(alpha=)`` and ``addcmul_`` may fuse a multiply
and an add, which moves a result by at most an ulp.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Callable, Iterator, NamedTuple, Optional

import torch

#: elements of one in-place update chunk (64 MB of float32)
CHUNK = 1 << 24


class AdamState(NamedTuple):
    mu: dict
    nu: dict
    count: torch.Tensor          # int32 0-d
    # float32 master weights when the params are not all float32
    master: Optional[dict] = None


def tree_leaves(tree) -> list:
    """The tensor leaves of a tree of dicts and NamedTuples (None leaves
    dropped), dict keys in sorted order: the order of ``jax.tree.leaves``."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [x for v in tree for x in tree_leaves(v)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the congruent leaves of dict trees."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def _chunks(t: torch.Tensor) -> Iterator[torch.Tensor]:
    return iter(t.view(-1).split(CHUNK))


@dataclasses.dataclass(frozen=True)
class AdamW:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: Optional[float] = 1.0

    def init(self, params: dict) -> AdamState:
        zeros = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                         params)
        needs_master = any(p.dtype != torch.float32
                           for p in tree_leaves(params))
        master = (tree_map(lambda p: p.float().clone(), params)
                  if needs_master else None)
        some = tree_leaves(params)[0]
        return AdamState(
            mu=zeros, nu=tree_map(torch.zeros_like, zeros),
            count=torch.zeros((), dtype=torch.int32, device=some.device),
            master=master)

    def update(self, grads: dict, state: AdamState, params: dict, lr,
               norm: Optional[torch.Tensor] = None) -> AdamState:
        """One step, in place: ``params``, ``state.mu``, ``state.nu`` and
        ``state.master`` are updated where they lie and ``grads`` (float32
        leaves, or leaves of the params' dtypes) is consumed as scratch.
        ``lr`` is a 0-d float32 tensor; ``norm``, the gradients' global
        norm, is computed here when not given.  Returns the new state
        (sharing the old one's tensors, its count one larger)."""
        scale = None
        if self.clip_norm is not None:
            if norm is None:
                norm = global_norm(grads)
            # the fused clip: a scale inside the update instead of a
            # clipped copy of the whole gradient tree
            scale = torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-9),
                                max=1.0)
        count = state.count + 1
        tf = count.float()
        bc1 = 1.0 - torch.pow(self.b1, tf)
        bc2 = 1.0 - torch.pow(self.b2, tf)
        lr = torch.as_tensor(lr, dtype=torch.float32, device=tf.device)
        leaves = zip(tree_leaves(grads), tree_leaves(state.mu),
                     tree_leaves(state.nu), tree_leaves(params),
                     tree_leaves(state.master) if state.master is not None
                     else [None] * len(tree_leaves(params)))
        for g, m, n, p, w in leaves:
            ws = _chunks(w) if w is not None else itertools.repeat(None)
            for gc, mc, nc, pc, wc in zip(_chunks(g), _chunks(m), _chunks(n),
                                          _chunks(p), ws):
                self._update_chunk(gc, mc, nc, pc, wc, scale, bc1, bc2, lr)
        return AdamState(mu=state.mu, nu=state.nu, count=count,
                         master=state.master)

    def _update_chunk(self, g, m, n, p, w, scale, bc1, bc2, lr) -> None:
        g = g.float() if g.dtype != torch.float32 else g
        if scale is not None:
            g.mul_(scale)
        m.mul_(self.b1).add_(g, alpha=1 - self.b1)
        n.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
        step = torch.div(n, bc2).sqrt_().add_(self.eps)     # the scratch
        step = torch.div(m, bc1, out=g).div_(step)          # g is spent
        w32 = p if w is None else w
        step.add_(w32, alpha=self.weight_decay)
        w32.sub_(step.mul_(lr))
        if w is not None:
            p.copy_(w)


def global_norm(tree, splits=None, mesh=None) -> torch.Tensor:
    """``sqrt(sum of every leaf's squares)`` in float32, the leaves summed in
    ``tree_leaves`` order.

    On a ``mesh`` whose ranks hold shards of the leaves, ``splits`` is a
    congruent tree of the mesh axes each leaf is split over
    (``sharding.spec_axes`` of its spec).  Every rank's per-leaf sums of
    squares are gathered over the whole mesh, and each leaf's shards are
    added once each (a replica along an axis the leaf is not split over
    counts once), in coordinate order: every rank computes the same bits
    from the same gathered numbers, so replicas updated with this norm
    never drift apart."""
    leaves = tree_leaves(tree)
    sq = [torch.sum(torch.square(x.float())) for x in leaves]
    if splits is not None and mesh is not None and mesh.distributed:
        sq = _sharded_squares(torch.stack(sq), _axes_leaves(splits), mesh)
    total = None
    for s in sq:
        total = s if total is None else total + s
    return torch.sqrt(total)


def _axes_leaves(tree) -> list:
    """The leaves of a dict tree whose leaves are tuples of mesh axes, in
    ``tree_leaves`` (sorted-key) order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _axes_leaves(tree[k])]
    return [tuple(tree)]


def _sharded_squares(local: torch.Tensor, splits: list, mesh) -> list:
    """Each leaf's whole sum of squares from every rank's ``local [n]``
    (see :func:`global_norm`)."""
    every = local
    for ax in reversed(mesh.axis_names):
        every = mesh.all_gather(every, ax)       # [*mesh shape, n]
    out = []
    for i, axes in enumerate(splits):
        idx = tuple(slice(None) if a in axes else 0 for a in mesh.axis_names)
        parts = every[idx + (i,)].reshape(-1)
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        out.append(total)
    return out


def clip_by_global_norm(tree, max_norm: float):
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda x: (x.float() * scale).to(x.dtype), tree)


# ---------------------------------------------------------------------------
# schedules: step (an int or an integer tensor) -> float32 0-d tensor


def _step_f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def warmup_cosine(base_lr: float, warmup: int, total: int,
                  min_frac: float = 0.1):
    def lr(step):
        s = _step_f32(step)
        warm = s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
        return base_lr * torch.where(s < warmup, warm, cos)
    return lr


def constant(base_lr: float):
    return lambda step: torch.tensor(base_lr, dtype=torch.float32,
                                     device=torch.as_tensor(step).device)


def rsqrt(base_lr: float, warmup: int = 1000):
    def lr(step):
        s = torch.clamp(_step_f32(step), min=1.0)
        return base_lr * torch.minimum(s / warmup, torch.sqrt(warmup / s))
    return lr
