"""Int8 gradient compression with error feedback.

The port of the JAX package's ``repro.train.compress``:
``compress_with_error_feedback`` quantizes each gradient leaf to symmetric
per-tensor int8 and back, carrying the quantization residual into an
error-feedback buffer (Seide et al. / 1-bit-SGD style EF).  On one device
it simulates the wire format bit for bit; the train step applies it where
the gradient all-reduce would be.

``compressed_psum``, the collective that sums int8 payloads across
devices, waits for training on a mesh (ROADMAP A10b).
"""
from __future__ import annotations

import torch


def quantize_int8(x: torch.Tensor):
    """Symmetric per-tensor int8.  Returns (q int8, scale float32 0-d)."""
    xf = x.float()
    amax = torch.clamp(xf.abs().max(), min=1e-12)
    scale = amax / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_with_error_feedback(grads: dict, ef: dict):
    """grads, ef: congruent trees of tensors (ef float32).  Returns
    (decompressed grads in each leaf's dtype, new ef)."""
    if isinstance(grads, dict):
        out = {k: compress_with_error_feedback(grads[k], ef[k])
               for k in grads}
        return ({k: v[0] for k, v in out.items()},
                {k: v[1] for k, v in out.items()})
    gf = grads.float() + ef
    q, scale = quantize_int8(gf)
    deq = dequantize_int8(q, scale)
    return deq.to(grads.dtype), gf - deq
