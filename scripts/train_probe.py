#!/usr/bin/env python3
"""Loss histories of starcoder2-7b's training path at cuts of its width,
depth and sequence: they tell AdamW's dynamics from a wrong gradient.

    python3 scripts/train_probe.py                        # on the card
    python3 scripts/train_probe.py --device cpu --only "w9 L2 s128"

Each case draws its parameters (seed 0), takes four ``make_train_step``
steps of AdamW under ``warmup_cosine(lr, 1, 4)`` (the first at rate 0, so
the first two losses are the random weights') on ``batch_for_step``'s
batches, and prints one JSON line: the case, the rate, each step's loss
and grad norm, and B6's launches.  The ``w9`` cases (9 heads of 128,
d_model 1,152, d_ff 4,608, 2 layers, 128 tokens) draw their parameters on
the CPU and move them to the device, so that a card run can be compared
with a CPU run entry by entry.  ``plain`` sends attention through the
plain version instead of B6 (``FlashAttentionFn``), ``f32`` computes in
float32; the other full-width cases are bf16 through B6.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.configs.shapes import ShapeConfig  # noqa: E402
from repro_torch.kernels.flash_attention import ops as faops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_gqa_ref)
from repro_torch.models import attention  # noqa: E402
from repro_torch.models.factory import build_model  # noqa: E402
from repro_torch.train.data import batch_for_step  # noqa: E402
from repro_torch.train.optimizer import AdamW, warmup_cosine  # noqa: E402
from repro_torch.train.train_step import (init_train_state,  # noqa: E402
                                          make_train_step)

W9 = dict(n_heads=9, n_kv_heads=1, d_model=1152, d_ff=4608)
#: (name, lr, seq, batch, microbatches, layers, options)
CASES = [
    ("w9 L2 s128", 1e-4, 128, 2, 1, 2, dict(width=W9, cpu_init=True)),
    ("w9 L2 s128", 3e-5, 128, 2, 1, 2, dict(width=W9, cpu_init=True)),
    ("w9 L2 s4096", 3e-5, 4096, 4, 4, 2, dict(width=W9)),
    ("full L12 s128", 3e-5, 128, 2, 1, 12, {}),
    ("full L1 s4096", 3e-5, 4096, 4, 4, 1, {}),
    ("full L2 s4096", 3e-5, 4096, 4, 4, 2, {}),
    ("full L12 s4096", 3e-5, 4096, 4, 4, 12, {}),
    ("full L12 s4096", 1e-5, 4096, 4, 4, 12, {}),
    ("full L12 s4096", 3e-6, 4096, 4, 4, 12, {}),
    ("full L12 s4096 plain", 3e-5, 4096, 4, 4, 12, dict(plain=True)),
    ("full L12 s4096 f32", 3e-5, 4096, 4, 4, 12, dict(dtype="float32")),
]


def _to(tree, dev):
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree.to(dev, copy=True)
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return type(tree)(*(_to(v, dev) for v in tree))


def _plain_attend(q, k, v, q_offset=0, **masks):
    return flash_attention_gqa_ref(q, k, v, q_offset=q_offset, **masks)


def run_case(name, lr, seq, batch, micro, layers, dev, width=None,
             cpu_init=False, plain=False, dtype="bfloat16") -> dict:
    cfg = dataclasses.replace(get_config("starcoder2-7b"),
                              compute_dtype=dtype, microbatches=micro,
                              n_layers=layers, **(width or {}))
    model = build_model(cfg)
    if cpu_init:
        state = _to(init_train_state(model, torch.Generator().manual_seed(0),
                                     AdamW(), device="cpu"), dev)
    else:
        state = init_train_state(
            model, torch.Generator(device=dev).manual_seed(0), AdamW(),
            device=dev)
    step = make_train_step(model, AdamW(), warmup_cosine(lr, 1, 4),
                           microbatches=micro)
    shape = ShapeConfig("probe", "train", seq, batch)
    kernel_attend = attention.attend
    if plain:
        attention.attend = _plain_attend
    n0 = faops.LAUNCHES["flash_attention"]
    hist = []
    try:
        for s in range(4):
            state, m = step(state, batch_for_step(cfg, shape, s, device=dev))
            hist.append([float(m["loss"]), float(m["grad_norm"])])
    finally:
        attention.attend = kernel_attend
    return {"case": name, "lr": lr, "loss_grad_norm": hist,
            "flash_launches": faops.LAUNCHES["flash_attention"] - n0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--only", default="",
                    help="run only the cases whose name starts so")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    for name, lr, seq, batch, micro, layers, opts in CASES:
        if not name.startswith(args.only):
            continue
        print(json.dumps(run_case(name, lr, seq, batch, micro, layers, dev,
                                  **opts)), flush=True)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
