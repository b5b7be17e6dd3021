"""Serve a small model with continuously-batched requests on the
PyTorch/CUDA port.

The decode batch is the serving-side fork-processing pattern: B
independent requests against the shared partitioned KV structure, with
finished slots refilled from the queue.  The model is the arch's reduced
twin with seeded random weights; its prefill attention runs the flash
kernel (``flash_tc_kernel``) on the card unless ``--device cpu`` is given.

    python examples/torch/serve_batched.py [--device cpu] [--arch qwen2-72b]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core.engine import resolve_device  # noqa: E402
from repro_torch.models.factory import build_model  # noqa: E402
from repro_torch.serve.engine import ContinuousBatcher, Request  # noqa


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    ap.add_argument("--arch", default="qwen2-72b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=10)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()   # small twin of the arch
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    rng = np.random.default_rng(0)

    batcher = ContinuousBatcher(model, params, batch_size=args.batch,
                                max_len=64, device=dev)
    for rid in range(args.requests):
        batcher.submit(Request(
            rid=rid,
            prompt=rng.integers(0, cfg.vocab,
                                rng.integers(3, 9)).astype(np.int32),
            max_new_tokens=args.max_new))
    t0 = time.perf_counter()
    out = batcher.run()
    dt = time.perf_counter() - t0
    print(f"{cfg.name} (reduced): served {len(out)} requests / "
          f"{batcher.tokens_out} tokens in {batcher.steps} decode steps, "
          f"{dt:.2f}s on {dev}")
    for rid in sorted(out)[:4]:
        print(f"  req {rid}: {out[rid]}")
    assert all(len(v) == args.max_new for v in out.values())
    print("serve OK")


if __name__ == "__main__":
    main()
