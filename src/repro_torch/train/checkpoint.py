"""Fault-tolerant checkpointing, in the JAX package's on-disk format.

The port of ``repro.train.checkpoint``:

* one ``.npy`` file per leaf, named by the CRC32 of its key path, the
  reference's path strings (``.params::stack::attn::wq``: a NamedTuple
  field as ``.name``, a dict key as itself, joined by ``::``);
* ``manifest.json`` records the step, an ``extra`` dict and each leaf's
  file, shape, dtype and CRC32; restore verifies every CRC before any
  state is touched;
* writes go to ``<dir>/tmp.<step>`` and commit with one ``os.rename`` to
  ``<dir>/step_<n>``: a job killed mid-write leaves the previous
  checkpoint intact;
* ``AsyncCheckpointer`` copies the tree to the host (a copy also of a
  CPU tensor), then writes it on a background thread (at most one save in flight; ``wait()`` joins and
  raises the writer's error);
* ``restore(..., target=)`` puts each leaf on the target leaf's device in
  its dtype.

numpy has no bfloat16: a bf16 leaf is written as its raw 16-bit words
(``uint16``) with ``"bfloat16"`` as its manifest dtype, and read back the
same way.

On a mesh a state holds each rank's shards.  ``save``/``AsyncCheckpointer``
with ``specs`` (the partition specs of ``train_step.state_shardings``) and
the ``mesh`` gather every leaf whole on the host, leaf by leaf, in one
order on every rank and on the calling thread (the writer thread makes no
collective), and only the world's rank 0 writes: the files are the
reference's, whole leaves, whatever mesh wrote them.  ``restore`` with
``shardings`` and ``rules`` cuts each whole leaf to the rank's block.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Any, Optional

import numpy as np
import torch

_SEP = "::"
_BF16 = "bfloat16"


def _is_spec(x) -> bool:
    """A partition spec: a plain tuple of mesh axes, tuples of them or
    None (``()``: replicated)."""
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        e is None or isinstance(e, (str, tuple)) for e in x)


def _flatten(tree, prefix=(), specs=False) -> dict:
    """``{key path: leaf}`` of a tree of dicts, NamedTuples and lists, in
    the reference's path strings; None leaves (an absent ``master`` or
    ``ef``) are no leaves.  ``specs``: the leaves are partition specs."""
    if tree is None:
        return {}
    if specs and _is_spec(tree):
        return {_SEP.join(prefix): tree}
    if isinstance(tree, dict):
        items = [(str(k), v) for k, v in sorted(tree.items())]
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = [("." + f, getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return {_SEP.join(prefix): tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, prefix + (k,), specs))
    return out


def _unflatten(target, leaves: dict, prefix=()):
    """``target``'s tree with each leaf replaced by ``leaves[path]``."""
    if target is None:
        return None
    if isinstance(target, dict):
        return {k: _unflatten(v, leaves, prefix + (str(k),))
                for k, v in target.items()}
    if isinstance(target, tuple) and hasattr(target, "_fields"):
        return type(target)(*(_unflatten(getattr(target, f), leaves,
                                         prefix + ("." + f,))
                              for f in target._fields))
    if isinstance(target, (list, tuple)):
        return type(target)(_unflatten(v, leaves, prefix + (str(i),))
                            for i, v in enumerate(target))
    return leaves[_SEP.join(prefix)]


def _to_numpy(x) -> np.ndarray:
    """A host copy of ``x``, never a view: ``.cpu()`` of a CPU tensor is
    the tensor itself, which the train step updates in place while the
    async writer reads it."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).to("cpu", copy=True).numpy().view(
                np.uint16)
        return x.to("cpu", copy=True).numpy()
    return np.array(x, copy=True)


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and d.split("_")[1].isdigit()]
    return max(steps) if steps else None


def _save_host(directory: str, step: int, flat: dict, dtypes: dict,
               extra: Optional[dict]) -> str:
    tmp = os.path.join(directory, f"tmp.{step}")
    final = os.path.join(directory, f"step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "extra": extra or {}, "leaves": {}}
    for key, arr in flat.items():
        fname = f"{zlib.crc32(key.encode()):08x}.npy"
        fpath = os.path.join(tmp, fname)
        np.save(fpath, arr)
        with open(fpath, "rb") as f:
            crc = zlib.crc32(f.read())
        manifest["leaves"][key] = {
            "file": fname, "shape": list(arr.shape),
            "dtype": dtypes.get(key, str(arr.dtype)), "crc32": crc}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)          # the commit
    return final


def _whole(x: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """The whole leaf of this rank's shard ``x`` (split by ``spec``),
    gathered on the host (CPU tensors through the mesh's collectives)."""
    from repro_torch.models.sharding import gather_dim
    x = x.detach().to("cpu", copy=True)
    with torch.no_grad():
        for d, entry in enumerate(spec):
            if entry is not None:
                x = gather_dim(x, d, entry, mesh)
    return x


def _writes(mesh) -> bool:
    """Whether this rank writes checkpoints: the world's rank 0."""
    return mesh is None or mesh.rank == 0


def _host(tree, specs=None, mesh=None) -> tuple:
    """(``{path: numpy array}``, ``{path: "bfloat16"}`` for bf16 leaves);
    with ``specs`` on a ``mesh`` of several ranks, each leaf gathered whole
    (an empty dict on a rank that does not write)."""
    flat = _flatten(tree)
    dtypes = {k: _BF16 for k, v in flat.items()
              if isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16}
    if specs is None or mesh is None or not mesh.distributed:
        return {k: _to_numpy(v) for k, v in flat.items()}, dtypes
    sflat = _flatten(specs, specs=True)
    out = {}
    for k, v in flat.items():
        whole = _whole(v, sflat[k], mesh)
        if _writes(mesh):
            out[k] = _to_numpy(whole)
        del whole
    return out, dtypes


def save(directory: str, step: int, tree: Any, extra: dict = None, *,
         specs=None, mesh=None) -> str:
    """Blocking save.  Returns the committed path.  With ``specs`` and a
    ``mesh``: ``tree`` is this rank's shards (module docstring); every rank
    of the mesh calls it and returns once the commit is done."""
    flat, dtypes = _host(tree, specs, mesh)
    final = os.path.join(directory, f"step_{step}")
    if _writes(mesh):
        final = _save_host(directory, step, flat, dtypes, extra)
    if mesh is not None:
        mesh.barrier()
    return final


def restore(directory: str, step: Optional[int] = None, *,
            target: Any = None, shardings: Any = None, rules=None,
            strict_crc: bool = True):
    """Restore a checkpoint (the newest when ``step`` is None).

    target: a tree of the desired structure whose leaves are tensors (each
    restored leaf goes to that tensor's device in its dtype; their shapes
    are not read) or numpy arrays; if None, returns the flat ``{key:
    np.ndarray}`` dict.  ``shardings`` (a partition spec tree congruent
    with ``target``) and ``rules`` (over the mesh to restore onto): each
    leaf is cut to this rank's block before it goes to the device.
    Returns (tree_or_flat, step, extra).
    """
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat, bf16 = {}, set()
    for key, meta in manifest["leaves"].items():
        fpath = os.path.join(path, meta["file"])
        if strict_crc:
            with open(fpath, "rb") as f:
                crc = zlib.crc32(f.read())
            if crc != meta["crc32"]:
                raise IOError(f"CRC mismatch for {key} in {path}")
        flat[key] = np.load(fpath)
        if meta["dtype"] == _BF16:
            bf16.add(key)
    if target is None:
        return flat, manifest["step"], manifest["extra"]
    tflat = _flatten(target)
    missing = set(tflat) - set(flat)
    if missing:
        raise KeyError(f"checkpoint missing leaves: {sorted(missing)[:5]}")
    sflat = (_flatten(shardings, specs=True) if shardings is not None
             and rules is not None else {})
    leaves = {}
    for key, tgt in tflat.items():
        arr = flat[key]
        t = (torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
             if key in bf16 else torch.from_numpy(arr))
        if key in sflat:
            from repro_torch.models.sharding import shard_by_spec
            t = shard_by_spec(t, sflat[key], rules.mesh)
        if isinstance(tgt, torch.Tensor):
            t = t.to(device=tgt.device, dtype=tgt.dtype)
        leaves[key] = t
    return _unflatten(target, leaves), manifest["step"], manifest["extra"]


class AsyncCheckpointer:
    """Background-thread writer; at most one save in flight.  With a
    ``mesh`` every rank calls ``save`` and ``wait`` at the same steps:
    the gathers run on the calling thread, rank 0's thread writes, and
    ``wait`` returns on every rank once that write is committed."""

    def __init__(self, directory: str, keep: int = 3, *, mesh=None):
        self.directory = directory
        self.keep = keep
        self.mesh = mesh
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    def save(self, step: int, tree: Any, extra: dict = None, *,
             specs=None):
        self.wait()
        # copy to the host before handing over to the thread, so that the
        # train step can update the device tensors in place at once
        flat, dtypes = _host(tree, specs, self.mesh)
        if not _writes(self.mesh):
            return

        def work():
            try:
                _save_host(self.directory, step, flat, dtypes, extra)
                self._gc()
            except BaseException as e:   # surfaced on the next wait()
                self._error = e
        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.mesh is not None:
            self.mesh.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = sorted(s for s in (
            int(d.split("_")[1]) for d in os.listdir(self.directory)
            if d.startswith("step_")))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)
