"""An op census of one program run: what ``dispatch.hygiene`` and
``ops.budgets`` read.

:class:`Census` is a ``TorchDispatchMode`` that classifies each operation
as ``launch/cost.StepCost`` does (``cost._classify``) but counts instead of
raising.  While it is active it records

* ``ops``: every operation that moves bytes, by name (views, allocations
  and metadata operations count nothing), and their total;
* ``host_reads``: reads of a device value back to the host, by what read
  it: ``_local_scalar_dense`` and ``is_nonzero`` (``bool``, ``int``,
  ``.item()``), an operation whose output shape depends on the data, and a
  copy from the card to the CPU (``_to_copy``, ``copy_``);
* ``launches``: calls of the hand-written kernels' wrappers, by kernel.
  A wrapper marked ``kernels.launch_site`` reports its call as one launch
  on either device, and the census counts nothing inside it: not the
  checks, and on the CPU not the plain version that stands in for the
  kernel (``Census.opaque``);
* ``wide``: operations with a float64 or complex output on the device.

On the CPU some reads dispatch nothing (``.tolist()``, ``.cpu()``, a
``.to()`` the CPU, ``.numpy()``), so while the census is active it wraps
those ``Tensor`` methods and counts them as the card would.  What such a
read returns is host memory, as on the card (``.cpu()`` and ``.to()``
return a copy): the census marks its storage, and what is computed from
host tensors alone (and tensors made from host data, ``torch.tensor`` and
``torch.from_numpy``), as the host's, whose later reads are no reads of
the device.
"""
from __future__ import annotations

import collections
import threading
from typing import Dict

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch import kernels as _kernels
from repro_torch.launch.cost import (_HOST, _MASKABLE, _META, _VIEW,
                                     _classify, _tensors)

aten = torch.ops.aten
#: operations that read one scalar back to the host
_SCALAR_READS = {aten._local_scalar_dense.default, aten.is_nonzero.default}
#: output dtypes the dtype contract forbids on the device
WIDE = (torch.float64, torch.complex64, torch.complex128)
#: ``Tensor`` methods that read without dispatching on the CPU
_CPU_READS = ("tolist", "cpu", "numpy", "to")

#: one census at a time (it is global to the kernel wrappers)
_active_lock = threading.Lock()


def _device_of(args, kwargs):
    """The device a ``Tensor.to`` call moves to, or None (a dtype cast)."""
    dev = kwargs.get("device")
    if dev is None:
        for a in args:
            if isinstance(a, (torch.device, str)):
                dev = a
                break
            if isinstance(a, torch.Tensor):
                dev = a.device
                break
    return None if dev is None else torch.device(dev)


class Census(TorchDispatchMode):
    """Counts one program's operations, host reads and kernel launches on
    ``device`` (see the module docstring)."""

    def __init__(self, device):
        super().__init__()
        self.device = torch.device(device).type
        self.ops: Dict[str, int] = collections.Counter()
        self.ops_total = 0
        self.host_reads = 0
        self.reads: Dict[str, int] = collections.Counter()
        self.launches: Dict[str, int] = collections.Counter()
        self.wide: Dict[str, int] = collections.Counter()
        self._depth = 0          # inside an opaque launch
        self._kinds: dict = {}
        self._host: dict = {}    # CPU: storages of host memory
        self._saved: dict = {}

    # -- the host's memory on the CPU ---------------------------------------

    def _is_host(self, t: torch.Tensor) -> bool:
        if self.device == "cuda":
            return t.device.type != "cuda"
        ref = self._host.get(t.untyped_storage()._cdata)
        return ref is not None and not ref.expired()

    def _mark_host(self, tree) -> None:
        if self.device != "cpu":
            return
        for t in tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                self._host[st._cdata] = StorageWeakRef(st)

    def _read(self, what: str) -> None:
        self.host_reads += 1
        self.reads[what] += 1

    # -- kernel launches -----------------------------------------------------

    def opaque(self, name: str, fn, args, kwargs):
        """Run a kernel wrapper as one launch of ``name``: nothing inside it
        is counted."""
        if self._depth:
            return fn(*args, **kwargs)
        self.launches[name] += 1
        self._depth += 1
        try:
            return fn(*args, **kwargs)
        finally:
            self._depth -= 1

    # -- entering and leaving ------------------------------------------------

    def __enter__(self):
        if not _active_lock.acquire(blocking=False):
            raise RuntimeError("another op census is active")
        _kernels.set_census(self)
        if self.device == "cpu":
            self._wrap_cpu_reads()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            for name, fn in self._saved.items():
                if name == "from_numpy":
                    torch.from_numpy = fn
                elif fn is None:        # inherited: drop the wrapper
                    delattr(torch.Tensor, name)
                else:
                    setattr(torch.Tensor, name, fn)
            self._saved.clear()
            _kernels.set_census(None)
            _active_lock.release()

    def _wrap_cpu_reads(self) -> None:
        census = self

        def wrap(name, orig):
            def method(t, *args, **kwargs):
                if census._depth or census._is_host(t):
                    return orig(t, *args, **kwargs)
                if name == "to":
                    dev = _device_of(args, kwargs)
                    if dev is None or dev.type != "cpu":
                        return orig(t, *args, **kwargs)
                census._read(f"Tensor.{name}")
                if name not in ("cpu", "to"):
                    return orig(t, *args, **kwargs)
                # host memory of its own, as the card's copy is
                census._depth += 1
                try:
                    out = orig(t, *args, **kwargs).clone()
                finally:
                    census._depth -= 1
                census._mark_host(out)
                return out
            return method

        for name in _CPU_READS:
            self._saved[name] = torch.Tensor.__dict__.get(name)
            setattr(torch.Tensor, name, wrap(name,
                                             getattr(torch.Tensor, name)))
        from_numpy = torch.from_numpy
        self._saved["from_numpy"] = from_numpy

        def host_from_numpy(a):
            out = from_numpy(a)
            census._mark_host(out)
            return out
        torch.from_numpy = host_from_numpy

    # -- dispatch ------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._depth:
            return out
        kind = self._kinds.get(func)
        if kind is None:
            kind = self._kinds[func] = _classify(func)
        if kind == _META:
            return out
        ins = _tensors(args, kwargs)
        on_device = [t for t in ins if not self._is_host(t)]
        if func in _SCALAR_READS or kind == _HOST or (
                kind == _MASKABLE and any(
                    t.dtype in (torch.bool, torch.uint8)
                    for t in _tensors(args[1:], {}))):
            if on_device:
                self._read(func._opname)
                self._mark_host(out)
        elif self.device == "cuda" and (
                (func is aten._to_copy.default
                 and kwargs.get("device") is not None
                 and torch.device(kwargs["device"]).type == "cpu"
                 and args[0].device.type == "cuda")
                or (func._opname == "copy_" and len(args) > 1
                    and args[0].device.type == "cpu"
                    and isinstance(args[1], torch.Tensor)
                    and args[1].device.type == "cuda")):
            self._read(func._opname)
        elif self.device == "cpu" and (
                func is aten.lift_fresh.default or (ins and not on_device)):
            self._mark_host(out)   # made from host data alone
        if kind != _VIEW:
            self.ops[func._opname] += 1
            self.ops_total += 1
            for t in tree_leaves(out):
                if (isinstance(t, torch.Tensor) and t.dtype in WIDE
                        and not self._is_host(t)):
                    self.wide[f"{func._opname}->{t.dtype}"] += 1
        return out

    def summary(self) -> dict:
        return {"ops_total": self.ops_total, "ops": dict(self.ops),
                "host_reads": self.host_reads, "reads": dict(self.reads),
                "launches": dict(self.launches), "wide": dict(self.wide)}


def run_counted(fn, args, device):
    """``(fn(*args), census)``: one run of ``fn`` under a fresh census."""
    census = Census(device)
    with census:
        out = fn(*args)
    return out, census
