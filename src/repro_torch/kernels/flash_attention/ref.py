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


def flash_attention_split_ref(q, k, v, *, rows, chunk, splits, causal=True,
                              window=None, q_offset=0, kv_len=None,
                              prefix_len=None):
    """The float32 kernel's arithmetic, block by block (tests only): q
    ``[B, Sq, H, hd]``, k, v ``[B, Skv, Hkv, hd]`` -> ``[B, Sq, H, hd]``.

    For each tile of ``rows`` queries, the kernel's chunk range (causal
    tiles end at their last query or past the prefix, windowed tiles
    without a prefix start at the window's lower edge rounded down to a
    chunk) is cut into ``splits`` fixed shares of whole ``chunk``-key
    chunks.  Each share runs the online softmax from ``(m, l, acc) = (-1e9,
    0, 0)``; a share that sees no key keeps that neutral partial.  The
    shares then merge in order: ``M = max m_t``, ``w_t = exp(m_t - M)``,
    ``out = sum w_t acc_t / max(sum w_t l_t, 1e-30)``."""
    B, Sq, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv

    def heads(x, rep):          # [B, S, H / rep, hd] -> [B * H, S, hd]
        x = x.float().repeat_interleave(rep, dim=2) if rep > 1 else x.float()
        return x.transpose(1, 2).reshape(B * H, -1, hd)
    qf = heads(q, 1) * (1.0 / (hd ** 0.5))
    kf, vf = heads(k, g), heads(v, g)
    kv_hi = Skv if kv_len is None else max(0, min(int(kv_len), Skv))
    pre = prefix_len or 0
    out = torch.empty((B * H, Sq, hd), dtype=torch.float32, device=q.device)
    for q0 in range(0, Sq, rows):
        q1 = min(q0 + rows, Sq)
        mask = attention_mask(q1 - q0, Skv, causal=causal, window=window,
                              q_offset=q_offset + q0, kv_len=kv_hi,
                              prefix_len=prefix_len, device=q.device)
        kv_end = kv_hi
        if causal:
            kv_end = max(min(kv_hi, q_offset + q1), min(pre, kv_hi))
        c_begin = 0
        if window is not None and pre <= 0:
            c_begin = max(0, q_offset + q0 - window + 1) // chunk * chunk
        n = -(-(kv_end - c_begin) // chunk) if kv_end > c_begin else 0
        parts = []
        for t in range(splits):
            m = torch.full((B * H, q1 - q0), NEG, device=q.device)
            l = torch.zeros_like(m)
            acc = torch.zeros((B * H, q1 - q0, hd), device=q.device)
            for c in range(n * t // splits, n * (t + 1) // splits):
                c0 = c_begin + c * chunk
                c1 = min(c0 + chunk, Skv)
                ok = mask[None, :, c0:c1]
                s = torch.where(ok, torch.matmul(qf[:, q0:q1],
                                                 kf[:, c0:c1].transpose(1, 2)),
                                NEG)
                mn = torch.maximum(m, torch.amax(s, dim=-1))
                r = torch.exp(m - mn)
                p = torch.where(ok, torch.exp(s - mn[..., None]), 0.0)
                l = l * r + torch.sum(p, -1)
                acc = acc * r[..., None] + torch.matmul(p, vf[:, c0:c1])
                m = mn
            parts.append((m, l, acc))
        M = torch.stack([m for m, _, _ in parts]).amax(0)
        L = torch.zeros_like(M)
        O = torch.zeros_like(parts[0][2])
        for m, l, acc in parts:
            w = torch.exp(m - M)
            L = L + l * w
            O = O + acc * w[..., None]
        out[:, q0:q1] = O / torch.clamp(L, min=1e-30)[..., None]
    return out.reshape(B, H, Sq, hd).transpose(1, 2).to(q.dtype)


#: query rows of one block of :func:`flash_attention_bwd_ref`
BWD_BLOCK = 512


def flash_attention_bwd_ref(q, k, v, out, dout, *, causal=True, window=None,
                            q_offset=0, kv_len=None, prefix_len=None):
    """The gradients ``(dq, dk, dv)`` of :func:`flash_attention_gqa_ref`'s
    output at ``dout``, each in its input's dtype: the standard flash
    backward in float32.  q, out, dout: ``[B, Sq, H, hd]``; k, v: ``[B,
    Skv, Hkv, hd]``; the masks as for the forward.

    ``D = rowsum(dout * out)``; then, for each block of at most
    ``BWD_BLOCK`` queries (all H // Hkv heads of a kv head together),
    recompute the scores, the mask and the normalised probabilities P, and
    accumulate ``dV += P^T dO``, ``dP = dO V^T``, ``dS = P (dP - D)``,
    ``dQ = scale dS K`` and ``dK += scale dS^T Q``.  A kv head's dK and dV
    sum its group's query heads in the products.  Peak memory is one
    ``[B*Hkv, group * BWD_BLOCK, Skv]`` float32 block of each of s, P and
    dP, never the whole ``[B*H, Sq, Skv]``.  ``out`` is the forward's
    output (rounded to its dtype), as a fused backward reads it."""
    B, Sq, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    scale = 1.0 / (hd ** 0.5)

    def heads(x, n):           # [B, S, n*?, hd] -> [B, Hkv, n?, S, hd]
        return x.float().permute(0, 2, 1, 3).reshape(B, Hkv, n, -1, hd)

    qf, of, dof = heads(q, g), heads(out, g), heads(dout, g)
    kf = k.float().permute(0, 2, 1, 3).reshape(B * Hkv, Skv, hd)
    vf = v.float().permute(0, 2, 1, 3).reshape(B * Hkv, Skv, hd)
    D = torch.sum(dof * of, dim=-1)                     # [B, Hkv, g, Sq]
    dq = torch.empty_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for i0 in range(0, Sq, BWD_BLOCK):
        i1 = min(Sq, i0 + BWD_BLOCK)
        n = i1 - i0

        def rows(x):           # [B, Hkv, g, n, hd] -> [B*Hkv, g*n, hd]
            return x[:, :, :, i0:i1].reshape(B * Hkv, g * n, -1)
        qb, dob = rows(qf), rows(dof)
        Db = D[:, :, :, i0:i1].reshape(B * Hkv, g * n, 1)
        mask = attention_mask(n, Skv, causal=causal, window=window,
                              q_offset=q_offset + i0, kv_len=kv_len,
                              prefix_len=prefix_len, device=q.device)
        mask = mask.repeat(g, 1)[None]                  # [1, g*n, Skv]
        s = torch.where(mask, torch.matmul(qb * scale, kf.transpose(1, 2)),
                        NEG)
        p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
        p = torch.where(mask, p, 0.0)
        p = p / torch.clamp(torch.sum(p, -1, keepdim=True), min=1e-30)
        del s
        dv += torch.matmul(p.transpose(1, 2), dob)
        ds = torch.matmul(dob, vf.transpose(1, 2))      # dP
        ds = p.mul_(ds.sub_(Db))                        # dS = P (dP - D)
        dq[:, :, :, i0:i1] = torch.matmul(ds, kf).mul_(scale).reshape(
            B, Hkv, g, n, hd)
        dk += torch.matmul(ds.transpose(1, 2), qb).mul_(scale)

    def back(x, n, like):      # [B, Hkv, n?, S, hd] -> [B, S, H?, hd]
        return x.reshape(B, Hkv * n, -1, hd).permute(0, 2, 1, 3).to(
            like.dtype).contiguous()
    return (back(dq, g, q), back(dk.view(B, Hkv, 1, Skv, hd), 1, k),
            back(dv.view(B, Hkv, 1, Skv, hd), 1, v))
