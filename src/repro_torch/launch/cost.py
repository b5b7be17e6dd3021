"""What one step costs a rank, counted while it runs on fake tensors.

The port's counterpart of the reference's ``hlo.cost_summary`` and of what
``probes.py`` composes from per-layer programs: XLA counts a ``while``
body once, so the reference compiles one probe per unit and multiplies by
trip counts; torch runs every iteration of the port's Python loops, so
one pass over the step counts each iteration (and the remat recompute,
which runs) exactly.

:class:`StepCost` is a ``TorchDispatchMode`` over tensors without data
(meta tensors, or fake ones under a ``FakeTensorMode``: ``launch/dryrun``).
While :attr:`StepCost.counting`, it records for every operation that
reaches the dispatcher:

* matmul FLOPs (``torch.utils.flop_counter``'s formulas, and B6's own,
  ``kernels/flash_attention/ops.flash_flops``), by operand dtype:
  ``"tensor"`` for bf16 / fp16 (the tensor cores), ``"fp32"`` for float32
  (the FP32 cores: the port keeps TF32 off), ``"other"`` else;
* bytes: each operation's tensor inputs read once and its outputs written
  once; views and allocation or metadata operations count nothing;
* launches of the port's hand-written kernels (the ``repro_torch`` custom
  ops), by name, and the count of every other operation that moves bytes
  (``ops``: PyTorch's own kernels, one launch each on the card);

and always (setup included) the live bytes of the storages on the step's
device, each rounded up to the caching allocator's 512-byte block, and
their peak.  A host read inside a step (``aten._local_scalar_dense``, a
copy to the CPU, an output whose shape depends on the data) raises
:class:`HostRead` naming the operation: the dry run records the cell as
``FAIL``.
"""
from __future__ import annotations

import collections

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils import flop_counter
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

#: the namespace of the port's kernel entry points (``torch.library``)
KERNEL_NS = "repro_torch"
#: the CUDA caching allocator's block: every allocation is rounded up to it
ALLOC_BLOCK = 512

aten = torch.ops.aten
#: operations that move or touch no element: allocations, metadata, and
#: the views the schema does not flag as such
_NO_BYTES = {aten.empty.memory_format, aten.empty_strided.default,
             aten.empty_like.default, aten.new_empty.default,
             aten.new_empty_strided.default, aten.detach.default,
             aten.alias.default, aten.lift_fresh.default,
             aten._unsafe_view.default, aten.set_.source_Storage,
             aten.set_.source_Storage_storage_offset,
             aten.resize_.default}
#: indexing, whose output shape depends on the data only with a mask
_INDEXING = {aten.index.Tensor, aten.index_put.default,
             aten.index_put_.default, aten._index_put_impl_.default}
#: what an operation is to :class:`StepCost` (:func:`_classify`)
_META, _HOST, _MASKABLE, _VIEW, _OP = range(5)


def _classify(func) -> int:
    if func.namespace == "prim" or func.name().startswith("aten::sym_"):
        return _META
    tags = func.tags
    if (torch.Tag.data_dependent_output in tags
            or func is aten.is_nonzero.default):
        return _HOST
    if torch.Tag.dynamic_output_shape in tags:
        return _MASKABLE if func in _INDEXING else _HOST
    if func.is_view or func in _NO_BYTES:
        return _VIEW
    return _OP


def _functional(func) -> bool:
    """Whether ``func`` writes no argument and returns fresh tensors."""
    schema = func._schema
    return not schema.is_mutable and all(
        r.alias_info is None for r in schema.returns)


def _key(a):
    """A hashable stand-in for an argument: a tensor's metadata, a
    list's items, a plain value itself (TypeError: not hashable)."""
    if isinstance(a, torch.Tensor):
        return (a.shape, a.stride(), a.dtype, a.device, a.storage_offset())
    if isinstance(a, (list, tuple)):
        return tuple(_key(x) for x in a)
    hash(a)
    return a


def _tensors(args, kwargs) -> list:
    """The tensors among an operation's arguments (and in their lists)."""
    out = []
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(x for x in a if isinstance(x, torch.Tensor))
    return out


class HostRead(RuntimeError):
    """A step read a device value on the host (or made a shape of one)."""


def flop_class(dtype: torch.dtype) -> str:
    """The cores a matmul of operands of ``dtype`` runs on."""
    if dtype in (torch.bfloat16, torch.float16):
        return "tensor"
    return "fp32" if dtype == torch.float32 else "other"


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StepCost(TorchDispatchMode):
    """Counts a step's FLOPs, bytes, launches and live memory on
    ``device`` (see the module docstring); set :attr:`counting` around
    the step."""

    def __init__(self, device):
        super().__init__()
        self.device = torch.device(device)
        self.counting = False
        self.flops = collections.Counter()
        self.flops_by_op = collections.Counter()
        self.bytes = 0
        self.ops = 0
        self.launches = collections.Counter()
        self.live = 0
        self.peak = 0
        self._storages: dict = {}
        self._kinds: dict = {}
        # output metadata of functional operations on meta tensors, by
        # their arguments' (a meta kernel is often Python: the layers
        # repeat, so most calls are hits)
        self._memo: dict = {} if self.device.type == "meta" else None

    # -- memory --------------------------------------------------------------

    def track(self, tree) -> None:
        """Count the storages of every tensor of ``tree`` as live (the
        state built before the mode counted its outputs)."""
        for t in tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                self._track(t)

    def _track(self, t: torch.Tensor) -> None:
        if t.device.type != self.device.type:
            return
        st = t.untyped_storage()
        key = st._cdata                  # the storage, whichever wrapper
        if key in self._storages:
            return
        nb = -(-st.nbytes() // ALLOC_BLOCK) * ALLOC_BLOCK
        self._storages[key] = (StorageWeakRef(st), nb)
        self.live += nb
        if self.live > self.peak:
            self._sweep()
            self.peak = max(self.peak, self.live)

    def _sweep(self) -> None:
        """Drop the storages freed since the last sweep from :attr:`live`
        (a storage's wrappers come and go; its weak reference expires
        with the storage itself).  ``live`` is an upper bound between
        sweeps, exact after one, and a sweep runs before any new peak is
        taken."""
        dead = [k for k, (ref, _) in self._storages.items() if ref.expired()]
        for k in dead:
            self.live -= self._storages.pop(k)[1]

    def reset_peak(self) -> None:
        self._sweep()
        self.peak = self.live

    # -- dispatch ------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        kind = self._kinds.get(func)
        if kind is None:
            kind = self._kinds[func] = _classify(func)
        if kind == _META:
            return func(*args, **kwargs)
        if kind == _HOST or (kind == _MASKABLE and any(
                t.dtype in (torch.bool, torch.uint8)
                for t in _tensors(args[1:], {}))) or (
                func is aten._to_copy.default
                and kwargs.get("device") is not None
                and torch.device(kwargs["device"]).type == "cpu"
                and args[0].device.type != "cpu"):
            raise HostRead(f"a host read inside the step: {func} (a value "
                           f"or an output shape that depends on the data)")
        out = self._run(func, kind, args, kwargs)
        outs = ([out] if isinstance(out, torch.Tensor)
                else [t for t in tree_leaves(out)
                      if isinstance(t, torch.Tensor)])
        for t in outs:
            self._track(t)
        if self.counting:
            self._count(func, kind, args, kwargs, out, outs)
        return out

    def _run(self, func, kind, args, kwargs):
        """``func(*args, **kwargs)``, from the memo where it can: a
        functional operation on meta tensors alone returns fresh meta
        tensors of the shapes, strides and dtypes its arguments' metadata
        gave before."""
        if self._memo is None or kind != _OP:
            return func(*args, **kwargs)
        devs = {t.device.type for t in _tensors(args, kwargs)}
        if kwargs.get("device") is not None:
            devs.add(torch.device(kwargs["device"]).type)
        if devs != {"meta"}:              # values someone may read
            return func(*args, **kwargs)
        try:
            key = (func, _key(args), _key(tuple(sorted(kwargs.items()))))
        except TypeError:
            return func(*args, **kwargs)
        hit = self._memo.get(key)
        if hit is not None:
            outs = [torch.empty_strided(sh, st, dtype=dt, device=dev)
                    for sh, st, dt, dev in hit[1]]
            return outs[0] if hit[0] else tuple(outs)
        out = func(*args, **kwargs)
        if not _functional(func):
            return out
        single = isinstance(out, torch.Tensor)
        outs = [out] if single else out
        if isinstance(outs, (list, tuple)) and all(
                isinstance(t, torch.Tensor) and t.storage_offset() == 0
                for t in outs) and len({t.untyped_storage()._cdata
                                        for t in outs}) == len(outs):
            if single or isinstance(out, tuple):
                self._memo[key] = (single, [(t.shape, t.stride(), t.dtype,
                                             t.device) for t in outs])
        return out

    def _count(self, func, kind, args, kwargs, out, outs) -> None:
        formula = flop_counter.flop_registry.get(func._overloadpacket)
        if formula is not None:
            first = _tensors(args, {})[0]
            n = int(formula(*args, **kwargs, out_val=out))
            self.flops[flop_class(first.dtype)] += n
            self.flops_by_op[str(func._overloadpacket)] += n
        if kind == _VIEW:
            return
        if func.namespace == KERNEL_NS:
            self.launches[func._opname] += 1
        else:
            self.ops += 1
        self.bytes += sum(_nbytes(t) for t in _tensors(args, kwargs)) + sum(
            _nbytes(t) for t in outs)

    def summary(self) -> dict:
        self._sweep()
        return {"flops": dict(self.flops),
                "flops_total": sum(self.flops.values()),
                "flops_by_op": dict(self.flops_by_op),
                "bytes": self.bytes, "ops": self.ops,
                "launches": dict(self.launches),
                "peak_bytes": self.peak}
