"""End-to-end LM training on the PyTorch/CUDA port: a ~100M-param dense
model, a few hundred steps, with checkpoint/restart fault tolerance.

    python examples/torch/train_lm.py --steps 200 [--ckpt-dir DIR]
    (kill it anytime; rerunning resumes from the last checkpoint)

The train step is ``train/train_step.make_train_step`` (AdamW, remat),
the loop ``train/loop.run_loop``; the batches are drawn by the threefry
kernel (``fg_threefry``) and the attention runs the flash kernel
(``flash_tc_kernel``) on the card unless ``--device cpu`` is given.
``--reduced`` trains the config's tiny twin (2 layers of 64).
"""
import argparse
import os
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.configs.shapes import ShapeConfig  # noqa: E402
from repro_torch.core.engine import resolve_device  # noqa: E402
from repro_torch.models.factory import build_model  # noqa: E402
from repro_torch.train.data import batch_for_step  # noqa: E402
from repro_torch.train.loop import LoopConfig, run_loop  # noqa: E402
from repro_torch.train.optimizer import (AdamW, tree_leaves,  # noqa: E402
                                         warmup_cosine)
from repro_torch.train.train_step import (init_train_state,  # noqa: E402
                                          make_train_step)

CFG_100M = ArchConfig(
    name="demo-100m", family="dense",
    n_layers=8, d_model=512, n_heads=8, n_kv_heads=4, d_ff=2816,
    vocab=49152, source="examples/train_lm.py")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        ROOT, "build", "train_lm_ckpt"))
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = CFG_100M.reduced() if args.reduced else CFG_100M
    model = build_model(cfg)
    opt = AdamW()
    state = init_train_state(model, torch.Generator(device=dev)
                             .manual_seed(0), opt, device=dev)
    n = sum(x.numel() for x in tree_leaves(state.params))
    print(f"model: {cfg.name} with {n / 1e6:.1f}M params on {dev}")
    shape = ShapeConfig("demo", "train", args.seq, args.batch)
    step = make_train_step(
        model, opt, warmup_cosine(3e-3, args.steps // 10, args.steps))
    lc = LoopConfig(n_steps=args.steps, ckpt_every=25,
                    ckpt_dir=args.ckpt_dir, log_every=10)
    state, stats = run_loop(
        step, state, lambda s: batch_for_step(cfg, shape, s, device=dev), lc)
    losses = [h["loss"] for h in stats.history]
    assert np.isfinite(losses).all(), losses
    print(f"done: {stats.steps_run} steps "
          f"(resumed from {stats.restored_step})"
          if stats.restored_step else f"done: {stats.steps_run} steps")
    print("train_lm OK")
    return stats


if __name__ == "__main__":
    main()
