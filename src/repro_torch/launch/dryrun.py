"""Multi-pod dry run of the port, with no card and no world.

The port of the JAX package's ``repro.launch.dryrun``.  For every
(architecture x input shape) cell it runs the port's own step program —
``train_step`` (train_4k), the serving prefill (prefill_32k) and decode
step (decode_32k, long_500k), built by ``launch/steps.build_setup`` — for
one rank of a production mesh:

    single-pod  (16, 16)       ("data", "model")        256 chips
    multi-pod   (2, 16, 16)    ("pod", "data", "model") 512 chips

The rank is a ``launch/mesh.DryMesh`` (its coordinates, no process group:
its collectives return outputs of the right shape and are counted).  Its
tensors hold no data and no memory: meta tensors, which B6's wrapper
routes as the card's (``kernels/flash_attention/ops``).  :func:`dry_step`
also runs on fake CUDA tensors (``FakeTensorMode``, ``device="cuda"``),
which a CUDA build of torch needs for their backward; the tests hold the
meta tensors' counts to theirs (``tests/test_torch_dryrun.py``).  Either
way the step takes the card's route: B6's kernel entry, whose fake
implementation gives its output's shape.  ``launch/cost.StepCost``
counts what the step does.

Each cell records, per rank run (rank 0 and the mesh's last by default,
``--rank`` to choose) and as the larger of each over them: the peak live
bytes (``peak_gb``, against the card's memory: ``OK`` when it fits,
``OK_OVER_HBM`` when not), FLOPs by class, bytes, collective calls and
bytes by kind and by axis, launches by kernel, and the run's own seconds;
``SKIP`` where the shape does not apply (``configs/shapes.applicable``),
``FAIL`` with the error where the step raises (a host read inside it is
one).  One JSON a cell goes to ``results/dryrun_torch/<arch>__<shape>__
<mesh>.json`` (``DRYRUN_OUT`` to move it); ``launch/roofline.py`` reads
them.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-72b --shape train_4k --mesh multi
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both [--jobs 6]
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import json
import multiprocessing
import os
import time
import traceback
from typing import Optional, Sequence

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._pytree import tree_leaves

from repro_torch.configs import base as cfg_base
from repro_torch.configs.shapes import SHAPES, applicable, skip_reason
from repro_torch.launch import roofline
from repro_torch.launch.cost import StepCost
from repro_torch.launch.mesh import chips, make_production_mesh
from repro_torch.launch.steps import build_setup

RESULTS = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "results", "dryrun_torch")
MESHES = ("single", "multi")


def out_dir() -> str:
    d = os.environ.get("DRYRUN_OUT", os.path.abspath(RESULTS))
    os.makedirs(d, exist_ok=True)
    return d


def dry_step(cfg, shape, mesh=None, *, rules=None, device="meta") -> dict:
    """One step of ``shape.kind`` for the rank of ``mesh`` (a ``DryMesh``,
    or None: one device) on tensors without data: meta tensors, or fake
    ones on ``device`` (module docstring).  Returns
    ``launch/cost.StepCost``'s summary (``peak_bytes`` counts the rank's
    arguments too), the mesh's collectives (``Mesh.collectives()``,
    counted over the step alone), the output leaves' shapes and the
    seconds it took."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.backends.cuda.is_built():
        # its backward would abort the process (no CUDA device guard)
        raise ValueError("fake CUDA tensors need a CUDA build of torch; "
                         "use device='meta'")
    t0 = time.perf_counter()
    fake = contextlib.nullcontext() if dev.type == "meta" else \
        FakeTensorMode()
    with fake, StepCost(dev) as cost:
        run, inputs = build_setup(cfg, shape, mesh, dev, rules)
        cost.track(inputs)
        cost.reset_peak()            # the arguments, not the setup's scratch
        if mesh is not None:
            mesh.reset_counts()
        cost.counting = True
        out = run()
        cost.counting = False
        shapes = [tuple(t.shape) for t in tree_leaves(out)
                  if isinstance(t, torch.Tensor)]
        del out, run, inputs
    rec = cost.summary()
    rec["collectives"] = (mesh.collectives() if mesh is not None
                          else {"calls": 0, "bytes": 0, "by_kind": {},
                                "by_axis": {}, "by_kind_axis": {}})
    rec["out_shapes"] = shapes
    rec["device"] = str(dev)
    rec["seconds"] = time.perf_counter() - t0
    return rec


def _larger(a, b):
    """The larger of two records' numbers, key by key (nested); a key in
    one record only keeps that record's value."""
    if isinstance(a, dict):
        return {k: (_larger(a[k], b[k]) if k in a and k in b
                    else a[k] if k in a else b[k])
                for k in sorted(set(a) | set(b))}
    if isinstance(a, (int, float)) and isinstance(b, (int, float)):
        return max(a, b)
    return a


#: the record keys taken as the larger over the ranks run
_MAXED = ("flops", "flops_total", "flops_by_op", "bytes", "ops", "launches",
          "peak_bytes", "collectives")


def run_cell(arch: str, shape_name: str, mesh_kind: str, *,
             ranks: Optional[Sequence[int]] = None, force: bool = False,
             write: bool = True) -> dict:
    """The record of one cell (module docstring); read from its JSON when
    it exists unless ``force``."""
    path = os.path.join(out_dir(), f"{arch}__{shape_name}__{mesh_kind}.json")
    if write and os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    cfg = cfg_base.get_config(arch)
    shape = SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "kind": shape.kind, "n_params": cfg.num_params(),
           "n_active_params": cfg.active_params()}
    if not applicable(cfg, shape_name):
        rec["status"] = "SKIP"
        rec["reason"] = skip_reason(cfg, shape_name)
        if write:
            _write(path, rec)
        return rec
    multi = mesh_kind == "multi"
    size = chips(make_production_mesh(multi_pod=multi, dry_rank=0))
    ranks = list(ranks) if ranks is not None else [0, size - 1]
    rec.update(chips=size, ranks=ranks, hbm_bytes=roofline.HBM_BYTES)
    t0 = time.perf_counter()
    try:
        per_rank = []
        for r in ranks:
            mesh = make_production_mesh(multi_pod=multi, dry_rank=r)
            one = dry_step(cfg, shape, mesh)
            per_rank.append({"rank": r, "coords": mesh.coords,
                             **{k: one[k] for k in _MAXED + ("seconds",)}})
        for k in _MAXED:
            v = per_rank[0][k]
            for one in per_rank[1:]:
                v = _larger(v, one[k])
            rec[k] = v
        rec["per_rank"] = per_rank
        rec["peak_gb"] = rec["peak_bytes"] / 2 ** 30
        rec["fits_hbm"] = rec["peak_bytes"] <= roofline.HBM_BYTES
        rec["status"] = "OK" if rec["fits_hbm"] else "OK_OVER_HBM"
    except Exception as e:                      # noqa: BLE001
        rec["status"] = "FAIL"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-3000:]
    rec["dry_run_s"] = time.perf_counter() - t0
    if write:
        _write(path, rec)
    return rec


def _write(path: str, rec: dict) -> None:
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=str)


def summary_line(rows: list) -> str:
    n_ok = sum(r["status"].startswith("OK") for r in rows)
    n_skip = sum(r["status"] == "SKIP" for r in rows)
    n_fail = sum(r["status"] == "FAIL" for r in rows)
    return (f"== dry-run: {n_ok} OK, {n_skip} SKIP, {n_fail} FAIL "
            f"of {len(rows)} cells ==")


def _print_row(rec: dict, seconds: float) -> None:
    status = rec["status"]
    if status.startswith("OK"):
        extra = (f"peak {rec['peak_gb']:>7.2f} GiB  "
                 f"dry {rec['dry_run_s']:6.1f}s")
    elif status == "SKIP":
        extra = rec["reason"][:60]
    else:
        extra = rec.get("error", "")[:90]
    print(f"{rec['arch']:25s} {rec['shape']:12s} {rec['mesh']:6s} "
          f"{status:12s} {extra}  [{seconds:5.1f}s]", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--rank", type=int, action="append", default=None,
                    help="a rank to run (repeat for more); default: rank 0 "
                         "and the mesh's last")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run at once, each in a process of its own")
    args = ap.parse_args(argv)

    archs = cfg_base.list_configs() if (args.all or not args.arch) \
        else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = list(MESHES) if args.mesh == "both" else [args.mesh]
    cells = [(a, sh, mk) for a in archs for sh in shapes for mk in meshes]
    kw = dict(ranks=args.rank, force=args.force)
    rows = []
    t0 = time.perf_counter()
    if args.jobs > 1:
        ctx = multiprocessing.get_context("spawn")
        with concurrent.futures.ProcessPoolExecutor(args.jobs,
                                                    mp_context=ctx) as pool:
            futs = [pool.submit(run_cell, *c, **kw) for c in cells]
            for f in futs:
                rows.append(f.result())
                _print_row(rows[-1], time.perf_counter() - t0)
    else:
        for c in cells:
            t0 = time.perf_counter()
            rows.append(run_cell(*c, **kw))
            _print_row(rows[-1], time.perf_counter() - t0)
    print("\n" + summary_line(rows))
    return 1 if any(r["status"] == "FAIL" for r in rows) else 0


if __name__ == "__main__":
    raise SystemExit(main())
