"""Plain PyTorch version of the flash-attention kernel.

What ``csrc/flash_attention.cu`` computes, written as whole-matrix PyTorch:
the CPU path of ``models/attention.attend`` and what the kernel is held
against on the card.  It materialises the ``[BH, Sq, Skv]`` scores, so it is
a reference, not a fast path.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG = -1e9


def attention_mask(sq: int, skv: int, *, causal: bool = True,
                   window: Optional[int] = None, q_offset: int = 0,
                   kv_len: Optional[int] = None,
                   prefix_len: Optional[int] = None,
                   device=None) -> torch.Tensor:
    """``[Sq, Skv]`` bool: query ``i`` at position ``q_offset + i`` may see
    key ``j`` at position ``j``.  ``causal`` keeps ``j <= q_pos``;
    ``window`` keeps ``j > q_pos - window``; ``prefix_len`` then adds every
    ``j < prefix_len`` (the prefix-LM mask); ``kv_len`` masks the padded
    keys ``j >= kv_len`` last: the reference's ``((causal & window) |
    prefix) & valid``."""
    q_pos = q_offset + torch.arange(sq, device=device)[:, None]
    kv_pos = torch.arange(skv, device=device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (kv_pos <= q_pos)
    if window is not None:
        mask = mask & (kv_pos > q_pos - window)
    if prefix_len is not None:
        mask = mask | (kv_pos < prefix_len)
    return mask & (kv_pos < (skv if kv_len is None else kv_len))


def flash_attention_ref(q, k, v, *, causal=True, window=None, q_offset=0,
                        kv_len=None, prefix_len=None):
    """q: [BH, Sq, hd]; k, v: [BH, Skv, hd] -> [BH, Sq, hd].

    float32 math on inputs of any dtype (q pre-scaled by ``1/sqrt(hd)``, as
    the kernel does), masked scores at -1e9, output
    ``acc / max(l, 1e-30)`` in the input dtype."""
    bh, sq, hd = q.shape
    skv = k.shape[1]
    scale = 1.0 / (hd ** 0.5)
    s = torch.matmul(q.float() * scale, k.float().transpose(1, 2))
    mask = attention_mask(sq, skv, causal=causal, window=window,
                          q_offset=q_offset, kv_len=kv_len,
                          prefix_len=prefix_len, device=q.device)
    s = torch.where(mask[None], s, NEG)
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    p = torch.where(mask[None], p, 0.0)
    out = torch.matmul(p, v.float()) / torch.clamp(
        torch.sum(p, -1, keepdim=True), min=1e-30)
    return out.to(q.dtype)


def flash_attention_gqa_ref(q, k, v, **kw):
    """q: [B, Sq, H, hd]; k, v: [B, Skv, Hkv, hd] -> [B, Sq, H, hd]:
    :func:`flash_attention_ref` with query head ``h`` reading key/value head
    ``h // (H // Hkv)``.  ``kw`` as for :func:`flash_attention_ref`."""
    B, Sq, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    kr = k.repeat_interleave(g, dim=2) if g > 1 else k
    vr = v.repeat_interleave(g, dim=2) if g > 1 else v
    qf = q.transpose(1, 2).reshape(B * H, Sq, hd)
    kf = kr.transpose(1, 2).reshape(B * H, Skv, hd)
    vf = vr.transpose(1, 2).reshape(B * H, Skv, hd)
    out = flash_attention_ref(qf, kf, vf, **kw)
    return out.reshape(B, H, Sq, hd).transpose(1, 2).contiguous()
