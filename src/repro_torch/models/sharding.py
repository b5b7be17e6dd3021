"""Logical-axis sharding rules (t5x style) and explicit per-rank shards.

The port of the JAX package's ``repro.models.sharding``.  Every parameter
leaf carries a tuple of *logical axis names*, one per dim
(``Model.param_axes()``); a rule set maps logical names to mesh axes, and
``AxisRules.spec`` turns one leaf's names into its partition spec: a tuple
of mesh-axis names (or a tuple of them, or None) per dim, trailing Nones
dropped, as a ``PartitionSpec`` holds them.  Two rules make a spec:

* a mesh axis is used at most once per leaf;
* with a shape, a mapping that does not divide its dim is dropped, so that
  dim is replicated (uneven sharding is never requested).

``spec`` needs only the mesh's axis sizes, so the rules can be built from
a ``{axis: size}`` mapping, without a world (the production meshes).

Where the reference hands a spec to GSPMD, the port keeps explicit shards:
:func:`local_shard` cuts a rank's block of a full leaf by its spec and the
mesh's coordinates (:func:`local_block`: where one dim's block starts),
and :func:`gather_dims` is its inverse over chosen axes, an all-gather per
sharded dim through ``launch/mesh.Mesh``.  A
model function that gets ``rules`` receives such blocks and knows a dim is
sharded when its length is below the config's full one.

Not ported: ``shard_map_compat`` and ``constrain``.  They are compiler
hints (shard_map across jax versions, ``with_sharding_constraint``) with no
torch counterpart: the port's partitioning is written out in
``models/manual_tp.py`` and never left to a compiler.

Logical axes used by the zoo:
  embed      d_model dim               -> FSDP axis ("data") by default
  vocab      vocabulary                -> "model"
  heads      attention query heads     -> "model" when divisible, else None
  kv_heads   GQA kv heads              -> "model" when divisible, else None
  head_dim   per-head dim              -> None
  mlp        FFN hidden                -> "model"
  experts    MoE expert dim            -> "model" (expert parallelism)
  expert_mlp per-expert FFN hidden     -> None (experts already sharded)
  inner      SSM / RG-LRU channel dim  -> "model" (channel parallelism)
  state      SSM state dim             -> None
  conv       conv kernel width         -> None
  dt         SSM dt-rank               -> None
  layers     stacked layer dim         -> None (never sharded)
  null       never sharded
"""
from __future__ import annotations

import math
from typing import Mapping, Optional, Sequence

import torch


class AxisRules:
    """Mapping logical axis name -> mesh axis (str | tuple | None).

    ``mesh`` is a ``launch/mesh.Mesh`` (its ``shape`` and ``coords`` cut the
    shards, its collectives gather them) or a ``{axis: size}`` mapping,
    enough for :meth:`spec`."""

    def __init__(self, rules: dict, mesh):
        self.rules = dict(rules)
        if isinstance(mesh, Mapping):
            self.mesh, sizes = None, dict(mesh)
        else:
            self.mesh, sizes = mesh, dict(mesh.shape)
        self._sizes = sizes

    def _mesh_size(self, axis) -> int:
        if axis is None:
            return 1
        if isinstance(axis, tuple):
            return math.prod(self._sizes[a] for a in axis)
        return self._sizes[axis]

    def spec(self, logical_axes: tuple, shape: Optional[tuple] = None
             ) -> tuple:
        """Partition spec of one leaf (see the module docstring)."""
        out, used = [], set()
        for i, name in enumerate(logical_axes):
            ax = self.rules.get(name)
            if ax is not None:
                key = tuple(ax) if isinstance(ax, tuple) else (ax,)
                if used & set(key):
                    ax = None          # a mesh axis may appear only once
                elif shape is not None and shape[i] % self._mesh_size(ax):
                    ax = None          # not divisible -> replicate this dim
                else:
                    used |= set(key)
            out.append(ax)
        while out and out[-1] is None:
            out.pop()
        return tuple(out)


# ---------------------------------------------------------------------------
# rule sets.  "data" doubles as the FSDP axis: the d_model ("embed") dim of
# every weight is sharded over it, so parameter memory scales down with both
# mesh axes.  Multi-pod meshes keep params replicated across pods.


def _batch_axis(names: Sequence[str]):
    return ("pod", "data") if "pod" in names else "data"


def default_rules(mesh, *, seq_shard_attn: bool = False) -> AxisRules:
    """TP over "model" + FSDP over "data" (``mesh`` as for
    :class:`AxisRules`).  ``seq_shard_attn`` sets the reference's
    context-parallel ``"seq"`` policy: a block whose heads do not divide
    the model axis runs each rank's block of query rows with every head
    where the axis divides the step's length (``models/manual_tp.py``'s
    ``"seq"`` layout)."""
    rules = {
        "embed": "data",
        "vocab": "model",
        "vocab_embed": None,
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "mlp": "model",
        "experts": "model",
        "expert_mlp": None,
        "expert_embed": "data",
        "inner": "model",
        "state": None,
        "conv": None,
        "dt": None,
        "layers": None,
        "null": None,
        # activation logical axes
        "seq": "model" if seq_shard_attn else None,
        "act_heads": "model",
        "act_mlp": "model",
        "act_vocab": "model",
        "seq_kv": "model",    # the partitioned-KV decode's cache
        "act_seq": "model",
    }
    names = mesh.axis_names if not isinstance(mesh, Mapping) else tuple(mesh)
    rules["batch"] = _batch_axis(names)
    return AxisRules(rules, mesh)


def replicated_rules(mesh) -> AxisRules:
    rules = {k: None for k in (
        "embed vocab vocab_embed heads kv_heads head_dim mlp experts "
        "expert_mlp expert_embed inner state conv dt layers null seq "
        "act_heads act_mlp act_vocab seq_kv act_seq").split()}
    names = mesh.axis_names if not isinstance(mesh, Mapping) else tuple(mesh)
    rules["batch"] = _batch_axis(names)
    return AxisRules(rules, mesh)


def batch_spec(rules: AxisRules, extra_dims: int = 1) -> tuple:
    """The spec of a ``[batch, ...]`` input."""
    return (rules.rules["batch"],) + (None,) * extra_dims


# ---------------------------------------------------------------------------
# explicit shards


def _axes_of(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _block(mesh, entry) -> tuple:
    """(this rank's index, count) of the blocks a dim splits into over the
    mesh axes of spec ``entry`` (row-major over a tuple of axes)."""
    axes = _axes_of(entry)
    return mesh.index(axes), math.prod(mesh.shape[a] for a in axes)


def local_shape(shape: tuple, logical_axes: tuple, rules: AxisRules
                ) -> tuple:
    """The shape of one rank's block of a leaf of full ``shape``."""
    spec = rules.spec(logical_axes, shape)
    return tuple(n // rules._mesh_size(spec[i]) if i < len(spec) else n
                 for i, n in enumerate(shape))


def local_shard(x: torch.Tensor, logical_axes: tuple, rules: AxisRules
                ) -> torch.Tensor:
    """This rank's block of the full leaf ``x`` by its spec, as a tensor of
    its own (the full one can be freed)."""
    return shard_by_spec(x, rules.spec(logical_axes, tuple(x.shape)),
                         rules.mesh)


def shard_by_spec(x: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of the full leaf ``x`` by the partition spec
    ``spec`` (as :meth:`AxisRules.spec` gives it) on ``mesh``, as a tensor
    of its own."""
    for d, entry in enumerate(spec):
        if entry is not None:
            i, n = _block(mesh, entry)
            size = x.shape[d] // n
            x = x.narrow(d, i * size, size)
    return x.clone(memory_format=torch.contiguous_format)


def local_block(name: str, full: int, rules: AxisRules) -> tuple:
    """(offset, count) of this rank's block of a dim of logical ``name``
    and whole length ``full``, as :func:`local_shard` cuts it: the whole
    dim when its mesh axes do not divide it (the spec guard)."""
    entry = rules.rules.get(name)
    n = rules._mesh_size(entry)
    if n == 1 or full % n:
        return 0, full
    i, _ = _block(rules.mesh, entry)
    return i * (full // n), full // n


def spec_axes(spec: tuple) -> tuple:
    """The mesh axes a partition spec splits a leaf over."""
    return tuple(a for entry in spec for a in _axes_of(entry))


def tree_specs(axes_tree, shapes_tree, rules: AxisRules):
    """The partition spec of every leaf of a nested-dict tree of logical
    axes, the divisibility guard on the congruent tree of full shapes."""
    if isinstance(axes_tree, dict):
        return {k: tree_specs(v, shapes_tree[k], rules)
                for k, v in axes_tree.items()}
    return rules.spec(axes_tree, tuple(shapes_tree))


def shard_tree(tree, axes_tree, rules: AxisRules):
    """:func:`local_shard` of every leaf of a nested-dict tree by the
    congruent axes tree (``Model.param_axes()``)."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, axes_tree[k], rules)
                for k, v in tree.items()}
    return local_shard(tree, axes_tree, rules)


def batch_axes(rules: AxisRules) -> tuple:
    """The mesh axes the rules split a batch over (``"data"``, or
    ``("pod", "data")``)."""
    return _axes_of(rules.rules.get("batch"))


def gather_dim(x: torch.Tensor, dim: int, entry, mesh,
               summed: tuple = ()) -> torch.Tensor:
    """The inverse of :func:`local_shard` along one dim: every rank's block
    over the mesh axes of spec ``entry``, concatenated in the order
    ``local_shard`` cut them.  Under autograd the gradient of ``x`` is the
    rank's block of the output's, summed first over the axes in ``summed``
    (the batch axes, whose ranks computed with other rows: the FSDP
    gather's adjoint is a reduce-scatter); along any other axis the ranks
    repeat one computation and the block is taken as it is."""
    for axis in reversed(_axes_of(entry)):
        if mesh.shape[axis] > 1:
            grad = "sum" if axis in summed else "slice"
            x = torch.cat(list(mesh.all_gather(x, axis, grad)), dim=dim)
    return x


def gather_dims(x: torch.Tensor, logical_axes: tuple, rules: AxisRules,
                full: dict) -> torch.Tensor:
    """``x`` with every dim whose logical name is in ``full`` and whose
    length is below ``full[name]`` gathered over the mesh axes that the
    rules map that name to (the spec guard leaves a dim either whole or
    evenly split, so a short dim is a sharded one).  ``full = {"embed":
    d_model}`` is the FSDP gather.  The adjoint follows :func:`gather_dim`
    with the rules' batch axes summed."""
    for d, name in enumerate(logical_axes):
        if name in full and x.shape[d] < full[name]:
            x = gather_dim(x, d, rules.rules[name], rules.mesh,
                           batch_axes(rules))
    return x


def batch_rows(batch: int, rules: AxisRules) -> slice:
    """The rows of a global batch of ``batch`` that this rank holds: its
    block over the rules' batch axes when they divide it, else all (a
    batch of one stays replicated, as the reference's tiny batches)."""
    entry = rules.rules.get("batch")
    n = rules._mesh_size(entry)
    if n == 1 or batch % n:
        return slice(0, batch)
    i, _ = _block(rules.mesh, entry)
    return slice(i * (batch // n), (i + 1) * (batch // n))
