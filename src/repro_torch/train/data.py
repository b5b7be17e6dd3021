"""Synthetic data stream of the train loop.

The port of the JAX package's ``repro.train.data``.  ``batch_for_step`` is
a pure function of (config, shape, step): the stream is deterministic and
random-access, so a restarted job regenerates exactly the batches it
would have seen (the bitwise resume depends on it, and data needs no
checkpoint).  It draws with the port's threefry stream (``core/prng.py``:
jax's bits, through the threefry kernel on the card), so ``tokens``,
``labels`` and ``loss_mask`` equal the reference's bit for bit on either
device.  ``image_embeds`` and ``frames`` (``prng.normal``) agree with the
reference's within a few float32 ulps of the normal draws, before the cast
to the compute dtype.

Tokens follow a Zipf-like distribution over the vocab: ``u ** (-1 / (a -
1))`` of uniforms in ``[1e-6, 1)``, truncated to an id.  The power is
taken in float64 and rounded to float32 (the correctly rounded power, as
the reference's ``pow`` on the CPU gives it wherever the truncated id can
tell): float32 ``pow`` differs between torch's CPU, its CUDA and XLA by an
ulp here and there.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.core import prng
from repro_torch.core.engine import resolve_device
from repro_torch.models.encdec import N_FRAMES


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    zipf_a: float = 1.2


def _zipf_tokens(key, shape, vocab: int, a: float) -> torch.Tensor:
    """Zipf-ish ids by the inverse CDF of uniforms (int32)."""
    u = prng.uniform(key, shape, 1e-6, 1.0)
    expo = float(np.float32(-1.0 / max(a - 1.0, 0.05)))
    r = torch.pow(u.double(), expo).float()
    # the id is int(r) - 1 clipped to the vocab: cap r first so that the
    # int32 conversion is defined (r reaches 1e30)
    r = torch.clamp(r, max=float(vocab + 1))
    return torch.clamp(r.to(torch.int32) - 1, 0, vocab - 1)


def batch_for_step(cfg: ArchConfig, shape: ShapeConfig, step: int,
                   dc: DataConfig = DataConfig(),
                   device=None) -> Dict[str, torch.Tensor]:
    """The batch of ``step`` on ``device`` (the card unless the caller asks
    for the CPU): ``tokens``, ``labels`` ``[B, S_text]`` int32 and
    ``loss_mask`` float32 (a document length per row in ``[S_text // 2,
    S_text]``); a vlm's ``image_embeds [B, num_image_tokens, D]`` (its
    ``S_text = S - num_image_tokens``) and an encdec's ``frames [B,
    N_FRAMES, D]``, both ``0.02 * normal`` in the compute dtype."""
    dev = resolve_device(device)
    B, S = shape.global_batch, shape.seq_len
    key = prng.fold_in(prng.PRNGKey(dc.seed, device=dev), step)
    k_tok, k_len, k_x = prng.split(key, 3)
    S_text = S - cfg.num_image_tokens if cfg.family == "vlm" else S
    stream = _zipf_tokens(k_tok, (B, S_text + 1), cfg.vocab, dc.zipf_a)
    tokens, labels = stream[:, :-1], stream[:, 1:]
    # variable document lengths -> loss mask (exercises masked CE)
    doc_len = prng.randint(k_len, (B,), S_text // 2, S_text + 1)
    mask = (torch.arange(S_text, device=dev)[None, :]
            < doc_len[:, None]).float()
    batch = {"tokens": tokens, "labels": labels, "loss_mask": mask}
    if cfg.family == "vlm":
        batch["image_embeds"] = (0.02 * prng.normal(
            k_x, (B, cfg.num_image_tokens, cfg.d_model))).to(cfg.cdtype)
    if cfg.family == "encdec":
        batch["frames"] = (0.02 * prng.normal(
            k_x, (B, N_FRAMES, cfg.d_model))).to(cfg.cdtype)
    return batch


def host_slice(batch: Dict[str, torch.Tensor], process_index: int,
               process_count: int) -> Dict[str, torch.Tensor]:
    """The slice of the global batch one of ``process_count`` hosts
    feeds."""
    def sl(x):
        per = x.shape[0] // process_count
        return x[process_index * per:(process_index + 1) * per]
    return {k: sl(v) for k, v in batch.items()}


def data_iterator(cfg: ArchConfig, shape: ShapeConfig, start_step: int = 0,
                  dc: DataConfig = DataConfig(),
                  device=None) -> Iterator[dict]:
    step = start_step
    while True:
        yield batch_for_step(cfg, shape, step, dc, device)
        step += 1
