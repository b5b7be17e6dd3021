#!/usr/bin/env python3
"""Compare the flash-attention kernels across source trees, on one card, in
turns.

    python3 scripts/flash_ab.py TREE [MORE_TREES ...] [--iters N] [--once]

Each tree is the root of a checkout of this repository (for example one
unpacked from ``git archive <commit>`` into a git-ignored directory such
as ``build/``).  The script compiles each tree's
``src/repro_torch/kernels/csrc/flash_attention.cu`` into that tree's own
``build/repro_torch/`` (all compiles in parallel; ptxas's report of the
float32 kernels is printed), then runs each tree in a fresh process, in
the order given and then reversed (A, B, B, A for two trees; with
``--once`` only in the order given):

  * the float32 kernel against its plain version (``FLASH_TOL["float32"]``
    of ``chip_smoke.py``) over a sweep of every head dim, every mask, GQA
    groups of 1, 8, 9 and 10, key splits of 1 to 8, a strided cache-prefix
    view and a base that is not 16-byte aligned;
  * card milliseconds of both kernels (float32 and bf16) at each of phase
    6's timed shapes (``chip_smoke.FLASH_TIMED``), each from a CUDA graph of
    ``--iters`` launches.

The first run also times PyTorch's SDPA in float32 at each timed shape (the
yardstick, never called by the port) and prints the card's name and power
limit.  One JSON line per run.  Compare two trees only within one run of
this script.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BUILD = r'''
import subprocess, sys
sys.path.insert(0, "src")
from repro_torch.kernels import _build
src = _build.CSRC / "flash_attention.cu"
_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
out = subprocess.run([_build._nvcc(), *_build._flags(src), "-o",
                      str(_build._target(src)), str(src)],
                     capture_output=True, text=True)
log = out.stdout + out.stderr
lines = log.splitlines()
for i, line in enumerate(lines):
    if "flash_fp32_kernel" in line and "Compiling entry" in line:
        print("\n".join(lines[i:i + 4]))
if out.returncode:
    print(log)
sys.exit(out.returncode)
'''

_RUN = r'''
import json, sys
sys.path.insert(0, "src")
sys.path.insert(0, ".")
import torch
import torch.nn.functional as F
import chip_smoke as cs
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import (attention_mask,
                                                     flash_attention_gqa_ref)
spec = json.loads(sys.argv[1])
dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(0)
torch.backends.cuda.matmul.allow_tf32 = False


def rnd(*shape, dtype=torch.float32):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


worst, failed = 0.0, []
for case in spec["sweep"]:
    B, Sq, Skv, H, Hkv, hd, kw, view = case
    q = rnd(B, Sq, H, hd)
    if view == "prefix":       # a prefix of a longer cache
        k = rnd(B, Skv + 256, Hkv, hd)[:, :Skv]
        v = rnd(B, Skv + 256, Hkv, hd)[:, :Skv]
    elif view == "unaligned":  # a base 4 bytes past a 16-byte boundary
        n = B * Skv * Hkv * hd
        k = rnd(n + 1)[1:].view(B, Skv, Hkv, hd)
        v = rnd(n + 1)[1:].view(B, Skv, Hkv, hd)
    else:
        k, v = rnd(B, Skv, Hkv, hd), rnd(B, Skv, Hkv, hd)
    got = ops.flash_attention(q, k, v, **kw)
    want = flash_attention_gqa_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    worst = max(worst, err)
    try:
        torch.testing.assert_close(got, want, **cs.FLASH_TOL["float32"])
    except AssertionError:
        failed.append([case, err])

ms, sdpa = {}, {}
for name, (H, Hkv, hd, c) in spec["timed"].items():
    kw = {k: c[k] for k in ("q_offset", "window", "causal", "kv_len",
                            "prefix_len")}
    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        q = rnd(1, c["Sq"], H, hd, dtype=dtype)
        k = rnd(1, c["Skv"], Hkv, hd, dtype=dtype)
        v = rnd(1, c["Skv"], Hkv, hd, dtype=dtype)
        ms[f"{name} {dname}"] = cs.device_ms(
            torch, lambda: ops.flash_attention(q, k, v, **kw),
            iters=spec["iters"])
        if spec["sdpa"] and dtype == torch.float32:
            mask = attention_mask(c["Sq"], c["Skv"], device=dev, **kw)
            qs, ks, vs = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            sdpa[name] = cs.device_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    qs, ks, vs, attn_mask=mask, enable_gqa=True),
                iters=spec["iters"])
        del q, k, v
        torch.cuda.empty_cache()
print(json.dumps({"sweep_cases": len(spec["sweep"]), "max_abs_err": worst,
                  "failed": failed, "ms": ms, "sdpa_f32_ms": sdpa}))
'''


def _sweep():
    """(B, Sq, Skv, H, Hkv, hd, masks, k/v view) of the correctness sweep."""
    out = []
    for hd in (16, 64, 128, 160, 256):
        out += [
            (1, 300, 300, 4, 1, hd, {"causal": True}, None),
            (2, 200, 700, 10, 1, hd, {"causal": True, "window": 130,
                                      "q_offset": 500}, None),
            # the window's lower edge empties whole splits
            (1, 64, 2048, 1, 1, hd, {"causal": True, "window": 100,
                                     "q_offset": 1984}, None),
            (1, 333, 333, 8, 1, hd, {"causal": True, "prefix_len": 70},
             None),
            (1, 150, 500, 9, 1, hd, {"causal": False, "kv_len": 389}, None),
            (1, 100, 600, 10, 1, hd, {"causal": True, "q_offset": 500},
             "prefix"),
            (1, 64, 2048, 1, 1, hd, {"causal": False}, None),
            (1, 37, 90, 4, 4, hd, {"causal": False, "kv_len": 0}, None),
            (1, 130, 130, 4, 2, hd, {"causal": True}, "unaligned"),
        ]
    return out


def _timed():
    """Phase 6's timed shapes: {arch: (H, Hkv, hd, case)}."""
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke as cs
    return {arch: (*cs.flash_heads(arch), cs._fcase(*shape))
            for arch, shape in cs.FLASH_TIMED.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--once", action="store_true",
                    help="run the trees once, in the order given")
    args = ap.parse_args(argv)
    trees = [os.path.abspath(t) for t in args.trees]
    with ThreadPoolExecutor(len(trees)) as ex:
        for tree, done in zip(trees, ex.map(lambda t: subprocess.run(
                [sys.executable, "-c", _BUILD], cwd=t, capture_output=True,
                text=True), trees)):
            print(f"{os.path.relpath(tree)} build:\n{done.stdout}"
                  f"{done.stderr[-4000:]}", flush=True)
            if done.returncode:
                return done.returncode
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    spec = {"sweep": _sweep(), "timed": _timed(), "iters": args.iters}
    for i, tree in enumerate(trees if args.once else trees + trees[::-1]):
        spec["sdpa"] = i == 0
        out = subprocess.run([sys.executable, "-c", _RUN, json.dumps(spec)],
                             cwd=tree, capture_output=True, text=True)
        if out.returncode:
            print(f"{os.path.relpath(tree)}: failed\n{out.stderr[-6000:]}",
                  flush=True)
            return 1
        print(os.path.relpath(tree), out.stdout.strip().splitlines()[-1],
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
