"""Roofline of the dry run's cells on the H100.

The port of the JAX package's ``repro.launch.roofline``.  It reads the
dry-run JSONs (``launch/dryrun.py``) and derives, per (arch x shape x
mesh) cell, for one rank (the larger of the ranks run):

    compute term    = tensor-core FLOPs / TENSOR_FLOPS
                      + float32 (and other) FLOPs / FP32_FLOPS      [s]
    memory term     = bytes / HBM_BW                               [s]
    collective term = sum over axes of the axis's bytes / its link [s]

The FLOPs are the step's matmuls by operand dtype and B6's kept pairs, the
bytes each operation's inputs once and outputs once, the collective bytes
the operands of every collective the rank entered (``launch/cost.py``,
``launch/mesh.DryMesh``): counted while the port's step ran, every loop
iteration and the remat recompute included.

Links: an axis whose rank groups (row-major ranks, as ``launch/mesh``
lays them) each lie within one 8-GPU node runs over NVLink 4 at
NVLINK_BW each way; any other axis over one 400 Gb/s InfiniBand port a GPU
(IB_BW).  At (16, 16) and (2, 16, 16) every axis spans nodes.

The constants are NVIDIA's published figures for the H100 SXM5 at 700 W
(dense bf16 989 TFLOP/s, FP32 67 TFLOP/s, HBM3 3.35 TB/s, NVLink 4 900
GB/s both ways), the card the smoke runs on (H100 80GB HBM3, 700.00 W).
``HBM_BYTES`` is that card's ``torch.cuda.get_device_properties(0)
.total_memory``, the memory "fits" is held to.

Also reported per cell, as the reference does: MODEL_FLOPS = 6·N·D for a
train step, 2·N·D for a prefill, 2·N·B for a decode step (N the active
params), per chip; the useful ratio MODEL_FLOPS / counted FLOPs (catches
remat and redundant work), the dominant term and a one-line note.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.roofline [--results results/dryrun_torch]
"""
from __future__ import annotations

import argparse
import glob
import itertools
import json
import math
import os

from repro_torch.configs import base as cfg_base
from repro_torch.configs.shapes import SHAPES

#: dense bf16 / fp16 tensor-core FLOP/s of the H100 SXM5
TENSOR_FLOPS = 989e12
#: FP32 (non-tensor) FLOP/s of the H100 SXM5
FP32_FLOPS = 67e12
#: HBM3 bytes/s of the H100 SXM5
HBM_BW = 3.35e12
#: NVLink 4 bytes/s each way a GPU (900 GB/s both ways)
NVLINK_BW = 450e9
#: one 400 Gb/s InfiniBand port a GPU, bytes/s
IB_BW = 50e9
#: GPUs a node joined by NVLink
NODE_GPUS = 8
#: total_memory of the H100 80GB HBM3 the smoke runs on
HBM_BYTES = 85_017_493_504

_RESULTS = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                        "results", "dryrun_torch")
_MESH_SHAPES = {"single": ((16, 16), ("data", "model")),
                "multi": ((2, 16, 16), ("pod", "data", "model"))}


def model_flops(cfg, shape, per_chip_chips=256) -> float:
    """Analytic MODEL_FLOPS for the whole step, per chip.

    train: 6*N*D  (D = tokens; fwd 2ND + bwd 4ND)
    prefill: 2*N*D
    decode: 2*N*1 token per sequence + attention KV read term is memory,
            not FLOPs-dominant; we report 2*N_active*B.
    """
    n = cfg.active_params()
    if shape.kind == "train":
        tokens = shape.seq_len * shape.global_batch
        return 6.0 * n * tokens / per_chip_chips
    if shape.kind == "prefill":
        tokens = shape.seq_len * shape.global_batch
        return 2.0 * n * tokens / per_chip_chips
    return 2.0 * n * shape.global_batch / per_chip_chips


def axis_in_node(shape: tuple, axis_names: tuple, axis) -> bool:
    """Whether every rank group of ``axis`` (None: the whole mesh) lies in
    one node of NODE_GPUS GPUs, ranks row-major."""
    size = math.prod(shape)
    if axis is None or axis == "all":
        return size <= NODE_GPUS
    a = axis_names.index(axis)
    stride = math.prod(shape[a + 1:])
    for coords in itertools.product(*(range(n) for i, n in enumerate(shape)
                                      if i != a)):
        base = sum(c * math.prod(shape[i + 1:]) for i, c in zip(
            (i for i in range(len(shape)) if i != a), coords))
        nodes = {(base + j * stride) // NODE_GPUS for j in range(shape[a])}
        if len(nodes) > 1:
            return False
    return True


def link_bw(shape: tuple, axis_names: tuple, axis) -> float:
    return NVLINK_BW if axis_in_node(shape, axis_names, axis) else IB_BW


def terms(flops: dict, nbytes: float, by_axis: dict, shape: tuple,
          axis_names: tuple) -> dict:
    """The three terms in seconds (module docstring)."""
    tensor = flops.get("tensor", 0)
    rest = sum(v for k, v in flops.items() if k != "tensor")
    return {"compute": tensor / TENSOR_FLOPS + rest / FP32_FLOPS,
            "memory": nbytes / HBM_BW,
            "collective": sum(
                row["bytes"] / link_bw(shape, axis_names, ax)
                for ax, row in by_axis.items())}


def analyze_record(rec: dict, mesh_shape=None) -> dict:
    """The roofline of one dry-run record (``mesh_shape``: ``(shape, axis
    names)``, default the production mesh of ``rec["mesh"]``)."""
    cfg = cfg_base.get_config(rec["arch"])
    shape = SHAPES[rec["shape"]]
    mshape, names = mesh_shape or _MESH_SHAPES[rec["mesh"]]
    t = terms(rec["flops"], rec["bytes"], rec["collectives"]["by_axis"],
              mshape, names)
    dom = max(t, key=t.get)
    mf = model_flops(cfg, shape, rec.get("chips", math.prod(mshape)))
    bound = max(t.values())
    return {"compute_s": t["compute"], "memory_s": t["memory"],
            "collective_s": t["collective"], "dominant": dom,
            "bound_s": bound,
            "model_flops_per_chip": mf,
            "useful_ratio": mf / max(rec["flops_total"], 1.0),
            # useful compute time at the tensor cores' rate over the
            # modeled step time (the balance assumption: max of the terms)
            "roofline_fraction": (mf / TENSOR_FLOPS) / max(bound, 1e-12),
            "note": _note(dom, cfg, shape)}


def _note(dom: str, cfg, shape) -> str:
    if dom == "compute":
        return ("compute-bound: raise useful ratio (less remat/redundant "
                "FLOPs) or grow per-chip batch")
    if dom == "memory":
        if shape.kind == "decode":
            return ("HBM-bound on KV/state streaming: shrink cache bytes "
                    "(bf16->int8 KV, window) or batch more queries per "
                    "load (the paper's move)")
        return ("HBM-bound: increase arithmetic intensity (fuse, bigger "
                "microbatch, bf16 master-free optimizer)")
    return ("collective-bound: reshard to cut cross-chip bytes (wider "
            "model axis hurts; try FSDP-only or 2D overlap), or overlap "
            "with compute")


def markdown(rows: list) -> str:
    """The run cells as a markdown table, one row an (arch, shape): for
    each mesh its status, peak GiB a rank, the three terms in seconds, the
    dominant term and the useful ratio."""
    by = {}
    for r in rows:
        by.setdefault((r["arch"], r["shape"]), {})[r["mesh"]] = r
    head = ("| arch | shape | " + " | ".join(
        f"{m}: status, peak GiB, compute · memory · collective s, dominant, "
        f"useful" for m in _MESH_SHAPES) + " |")
    out = [head, "|---|---|" + "---|" * len(_MESH_SHAPES)]
    for (arch, shape), cells in by.items():
        if all(c["status"] == "SKIP" for c in cells.values()):
            continue
        parts = []
        for m in _MESH_SHAPES:
            c = cells.get(m)
            if c is None or "compute_s" not in c:
                parts.append(c["status"] if c else "–")
                continue
            parts.append(f"{c['status']}, {c['peak_gb']:.2f}, "
                         f"{c['compute_s']:.4g} · {c['memory_s']:.4g} · "
                         f"{c['collective_s']:.4g}, {c['dominant']}, "
                         f"{c['useful_ratio']:.3f}")
        out.append(f"| {arch} | {shape} | " + " | ".join(parts) + " |")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--results", default=os.path.abspath(_RESULTS))
    ap.add_argument("--out", default=None,
                    help="default: roofline_torch.json beside the results")
    ap.add_argument("--markdown", action="store_true",
                    help="print one table row an (arch, shape), the "
                         "meshes side by side")
    args = ap.parse_args(argv)
    out = args.out or os.path.join(args.results, "..", "roofline_torch.json")
    rows = []
    for path in sorted(glob.glob(os.path.join(args.results, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        head = {"arch": rec["arch"], "shape": rec["shape"],
                "mesh": rec["mesh"], "status": rec["status"]}
        if rec["status"] == "SKIP":
            rows.append({**head, "reason": rec["reason"]})
        elif rec["status"] == "FAIL":
            rows.append({**head, "error": rec.get("error")})
        else:
            rows.append({**head, "peak_gb": rec["peak_gb"],
                         **analyze_record(rec)})
    with open(out, "w") as f:
        json.dump(rows, f, indent=1)
    if args.markdown:
        print(markdown(rows))
        return 0
    hdr = (f"{'arch':22s} {'shape':12s} {'mesh':6s} {'status':11s} "
           f"{'peak GiB':>8s} {'compute':>9s} {'memory':>9s} {'collect':>9s} "
           f"{'dom':>10s} {'useful':>7s}")
    print(hdr)
    print("-" * len(hdr))
    for r in rows:
        lead = f"{r['arch']:22s} {r['shape']:12s} {r['mesh']:6s} " \
               f"{r['status']:11s}"
        if "compute_s" not in r:
            print(lead)
            continue
        print(f"{lead} {r['peak_gb']:8.2f} {r['compute_s']:9.4f} "
              f"{r['memory_s']:9.4f} {r['collective_s']:9.4f} "
              f"{r['dominant']:>10s} {r['useful_ratio']:7.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
