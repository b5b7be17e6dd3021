"""Train step: microbatched gradient accumulation, AdamW and metrics.

The port of the JAX package's ``repro.train.train_step`` on one device.
Gradients are accumulated in float32 over the microbatches and scaled by
``1 / microbatches``, the metrics averaged, as the reference's scan does.

Each parameter's gradient is added into the float32 accumulator as soon as
autograd has it: the step differentiates detached leaves (one per layer of
a stacked leaf) whose post-accumulate hook adds the gradient into its
slice of the accumulator and drops it.  So at most one layer's gradients
are live besides the accumulator, where letting the stacked parameters
collect their own gradients would hold every layer's until the end of the
backward and then stack them into a second copy (12 GB each at
starcoder2-7b's width and 12 layers).

Int8 gradient compression with error feedback (``compression``) is
applied to the accumulated gradients, where the reference's all-reduce
boundary is; the residual rides in ``TrainState.ef``.  The step updates
the state in place (the reference donates it): ``train_step(state,
batch)`` consumes ``state`` and returns the new one, which shares its
tensors.

On a mesh (``rules``: tensor parallel over ``"model"``, FSDP over
``"data"``) the state holds the rank's shards (:func:`shard_state`, or
``convert.train_state_from_arrays(..., rules=)``) and every rank gets the
whole batch.  Each microbatch is cut from the global batch first, in the
reference's order, and ``Model.loss(rules=)`` takes the rank's rows of
it.  The collectives' adjoints (``launch/mesh.py``) leave each leaf's
gradient complete over ``"model"``; a leaf split over ``"data"`` gets its
sum over it from the FSDP gather's reduce-scatter, any other leaf one sum
over the batch axes after the last microbatch.  Compression takes each
leaf's scale over all its shards, and the global norm counts each shard
once (``optimizer.global_norm``), the same bits on every rank.
:func:`state_shardings` and :func:`batch_shardings` give the reference's
partition specs as tuples.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core.engine import resolve_device
from repro_torch.models.factory import Model
from repro_torch.models.sharding import (batch_axes, shard_by_spec,
                                         spec_axes, tree_specs)
from repro_torch.train import compress as compress_lib
from repro_torch.train.optimizer import AdamState, AdamW, global_norm, tree_map

#: top-level keys of the params whose leaves are stacked on a layer axis
STACKS = ("stack", "groups", "tail", "encoder", "decoder")
_METRICS = ("loss", "ce", "aux")


class TrainState(NamedTuple):
    params: dict
    opt: AdamState
    step: torch.Tensor            # int32 0-d
    ef: Optional[dict] = None     # error-feedback residual (compression)


def init_train_state(model: Model, generator: Optional[torch.Generator],
                     optimizer: AdamW, compression: bool = False,
                     device=None) -> TrainState:
    """Parameters drawn from ``generator`` in the reference's dtypes
    (``Model.init(train=True)``) on ``device`` (the card unless the caller
    asks for the CPU), AdamW's zero state, step 0."""
    dev = resolve_device(device)
    params = model.init(generator, dev, train=True)
    ef = (tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                   params) if compression else None)
    return TrainState(params=params, opt=optimizer.init(params),
                      step=torch.zeros((), dtype=torch.int32, device=dev),
                      ef=ef)


def _accumulating(p: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """A leaf viewing ``p`` whose gradient is added into ``acc`` (in
    place, in float32) as soon as autograd has it, then dropped."""
    leaf = p.detach().requires_grad_()

    def hook(t):
        acc.add_(t.grad)
        t.grad = None
    leaf.register_post_accumulate_grad_hook(hook)
    return leaf


def _grad_leaves(params: dict, acc: dict) -> dict:
    """``params`` as accumulating leaves: a stacked leaf becomes the list
    of its layers' (``transformer.unstack`` reads either)."""
    def walk(p, a, stacked):
        if isinstance(p, dict):
            return {k: walk(p[k], a[k], stacked) for k in p}
        if stacked:
            return [_accumulating(pi, ai)
                    for pi, ai in zip(p.unbind(0), a.unbind(0))]
        return _accumulating(p, a)
    return {k: walk(v, acc[k], k in STACKS) for k, v in params.items()}


def param_splits(model: Model, rules) -> dict:
    """The mesh axes each param leaf is split over, by its spec."""
    return tree_map(spec_axes, tree_specs(model.param_axes(),
                                          model.param_shapes(), rules))


def _sum_batch_axes(grads: dict, splits: dict, rules) -> None:
    """Sum in place, over each batch axis that does not split it, every
    gradient leaf (a leaf split over an axis got that sum from its
    gather's reduce-scatter)."""
    def one(g, split):
        for ax in batch_axes(rules):
            if ax not in split and rules.mesh.shape[ax] > 1:
                g.copy_(rules.mesh.all_reduce_sum(g, ax))
    tree_map(one, grads, splits)


def grads_of(model: Model, params: dict, batch: dict, *, rules=None,
             microbatches: int = 1, remat: bool = True, splits=None):
    """The gradients of ``model.loss`` over ``batch`` in ``microbatches``
    (float32, summed over them and scaled by ``1 / microbatches``) and the
    metrics averaged over them.  With ``rules``: the rank's shards of the
    gradients, ``splits`` the mesh axes each leaf is split over (module
    docstring)."""
    acc = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                   params)
    n = next(iter(batch.values())).shape[0]
    if n % microbatches:
        raise ValueError(f"batch of {n} does not split into "
                         f"{microbatches} microbatches")
    per = n // microbatches
    m_acc = None
    for i in range(microbatches):
        mb = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
        loss, metrics = model.loss(_grad_leaves(params, acc), mb, rules,
                                   remat)
        loss.backward()
        m = {k: metrics[k].detach() for k in _METRICS}
        m_acc = m if m_acc is None else {k: m_acc[k] + m[k] for k in m}
    if rules is not None:
        _sum_batch_axes(acc, splits or param_splits(model, rules), rules)
    if microbatches > 1:
        inv = 1.0 / microbatches
        tree_map(lambda g: g.mul_(inv), acc)
        m_acc = {k: v * inv for k, v in m_acc.items()}
    return acc, m_acc


def make_train_step(model: Model, optimizer: AdamW, lr_fn: Callable, *,
                    rules=None, microbatches: int = 1, remat: bool = True,
                    compression: bool = False) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``; the
    metrics are 0-d float32 tensors: ``loss``, ``ce``, ``aux`` (averaged
    over the microbatches), ``lr`` and ``grad_norm`` (of the gradients
    the optimizer takes, before its clip).  With ``rules`` the state is
    the rank's shards and ``batch`` the whole global batch (module
    docstring)."""
    splits = mesh = None
    if rules is not None:
        splits, mesh = param_splits(model, rules), rules.mesh

    def train_step(state: TrainState, batch):
        grads, metrics = grads_of(model, state.params, batch, rules=rules,
                                  microbatches=microbatches, remat=remat,
                                  splits=splits)
        ef = state.ef
        if compression:
            grads, ef = compress_lib.compress_with_error_feedback(
                grads, ef, mesh)
        lr = lr_fn(state.step)
        norm = global_norm(grads, splits, mesh)
        opt = optimizer.update(grads, state.opt, state.params, lr, norm=norm)
        metrics = dict(metrics, lr=lr, grad_norm=norm)
        return TrainState(params=state.params, opt=opt, step=state.step + 1,
                          ef=ef), metrics

    return train_step


# ---------------------------------------------------------------------------
# partition specs of the state and the batch


def state_shardings(state, axes: dict, rules) -> TrainState:
    """The partition spec tree of a ``TrainState`` (the reference's
    ``state_shardings``, each ``PartitionSpec`` as a tuple): the params by
    their logical ``axes`` with the divisibility guard on their shapes
    (``state.params``' leaves are whole shapes or have one as ``.shape``),
    ``mu``, ``nu``, ``master`` and ``ef`` as the params, ``count`` and
    ``step`` replicated (``()``)."""
    param = tree_specs(axes, tree_map(lambda p: tuple(getattr(p, "shape", p)),
                                      state.params), rules)
    master = getattr(state.opt, "master", None)
    return TrainState(
        params=param,
        opt=AdamState(mu=param, nu=param, count=(),
                      master=None if master is None else param),
        step=(), ef=None if state.ef is None else param)


def batch_shardings(batch_specs: dict, rules) -> dict:
    """The partition spec of each batch input (leaves with ``.shape``):
    its rows over the rules' batch axes, every other dim whole."""
    b = rules.rules["batch"]
    return {k: (b,) + (None,) * (len(v.shape) - 1)
            for k, v in batch_specs.items()}


def shard_state(state: TrainState, specs: TrainState, mesh) -> TrainState:
    """The rank's shards of a whole ``state`` by its spec tree
    (:func:`state_shardings`), each a tensor of its own."""
    def cut(x, spec):
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: cut(x[k], spec[k]) for k in x}
        return shard_by_spec(x, spec, mesh)
    opt = state.opt
    return TrainState(
        params=cut(state.params, specs.params),
        opt=AdamState(mu=cut(opt.mu, specs.opt.mu),
                      nu=cut(opt.nu, specs.opt.nu), count=opt.count,
                      master=cut(opt.master, specs.opt.master)),
        step=state.step, ef=cut(state.ef, specs.ef))
