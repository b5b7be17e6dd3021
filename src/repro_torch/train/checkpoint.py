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


def _flatten(tree, prefix=()) -> dict:
    """``{key path: leaf}`` of a tree of dicts, NamedTuples and lists, in
    the reference's path strings; None leaves (an absent ``master`` or
    ``ef``) are no leaves."""
    if tree is None:
        return {}
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
        out.update(_flatten(v, prefix + (k,)))
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


def _host(tree) -> tuple:
    """(``{path: numpy array}``, ``{path: "bfloat16"}`` for bf16 leaves)."""
    flat = _flatten(tree)
    dtypes = {k: _BF16 for k, v in flat.items()
              if isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16}
    return {k: _to_numpy(v) for k, v in flat.items()}, dtypes


def save(directory: str, step: int, tree: Any, extra: dict = None) -> str:
    """Blocking save.  Returns the committed path."""
    return _save_host(directory, step, *_host(tree), extra)


def restore(directory: str, step: Optional[int] = None, *,
            target: Any = None, strict_crc: bool = True):
    """Restore a checkpoint (the newest when ``step`` is None).

    target: a tree of the desired structure whose leaves are tensors (each
    restored leaf goes to that tensor's device in its dtype) or numpy
    arrays; if None, returns the flat ``{key: np.ndarray}`` dict.
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
    leaves = {}
    for key, tgt in tflat.items():
        arr = flat[key]
        t = (torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
             if key in bf16 else torch.from_numpy(arr))
        if isinstance(tgt, torch.Tensor):
            t = t.to(device=tgt.device, dtype=tgt.dtype)
        leaves[key] = t
    return _unflatten(target, leaves), manifest["step"], manifest["extra"]


class AsyncCheckpointer:
    """Background-thread writer; at most one save in flight."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    def save(self, step: int, tree: Any, extra: dict = None):
        self.wait()
        # copy to the host before handing over to the thread, so that the
        # train step can update the device tensors in place at once
        flat, dtypes = _host(tree)

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
