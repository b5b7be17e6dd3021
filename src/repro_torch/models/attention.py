"""Attention for the LM stack.

The port of the JAX package's ``repro.models.attention`` (its dense,
single-device paths):

* ``attend``              — prefill and training attention over a whole
  prompt or a chunk of one.  On a CUDA tensor it runs the hand-written
  flash-attention kernel (``kernels/flash_attention``, one launch per call,
  GQA in the kernel); on a CPU tensor the kernel's plain version.  There is
  no fallback between them.  It carries a gradient on both devices: on the
  card through ``FlashAttentionFn`` (the kernel forward, the plain flash
  backward), on the CPU through autograd of the plain version.
* ``decode_attend_local`` — one new token against an unsharded KV cache,
  plain PyTorch (the JAX package keeps it in plain XLA too).
* ``decode_attend_partitioned`` — the same against a KV cache whose
  sequence axis is sharded over a mesh's ``model`` axis (``launch/mesh``):
  each rank attends over its shard and ``combine_partials`` merges the
  partial softmaxes after one all-gather of them, serving's form of the
  runtime's boundary exchange.  ``Model.decode(mesh=..., rules=...)``
  keeps the cache sharded this way; ``cache_update_sharded`` writes a new
  token's keys and values on the rank whose shard owns its slot.

GQA throughout: Hkv kv-heads are broadcast over group = H // Hkv query heads
(query head ``h`` reads kv-head ``h // group``).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models.layers import _normal, apply_rope

NEG = -1e9  # mask value: large-negative (never -inf: exp() stays NaN-free)


# ---------------------------------------------------------------------------
# params


def attention_axes(qkv_bias=False) -> dict:
    a = {"wq": ("embed", "heads", "head_dim"),
         "wk": ("embed", "kv_heads", "head_dim"),
         "wv": ("embed", "kv_heads", "head_dim"),
         "wo": ("heads", "head_dim", "embed")}
    if qkv_bias:
        a.update(bq=("heads", "head_dim"), bk=("kv_heads", "head_dim"),
                 bv=("kv_heads", "head_dim"))
    return a


def init_attention(gen, d, n_heads, n_kv, head_dim, dtype, qkv_bias=False,
                   device=None):
    s = 1.0 / math.sqrt(d)
    so = 1.0 / math.sqrt(n_heads * head_dim)
    p = {"wq": _normal(gen, (d, n_heads, head_dim), dtype, s, device),
         "wk": _normal(gen, (d, n_kv, head_dim), dtype, s, device),
         "wv": _normal(gen, (d, n_kv, head_dim), dtype, s, device),
         "wo": _normal(gen, (n_heads, head_dim, d), dtype, so, device)}
    if qkv_bias:
        p.update(bq=torch.zeros((n_heads, head_dim), dtype=dtype,
                                device=device),
                 bk=torch.zeros((n_kv, head_dim), dtype=dtype, device=device),
                 bv=torch.zeros((n_kv, head_dim), dtype=dtype, device=device))
    return p


def _proj(x, w):
    """``einsum("bsd,dhk->bshk", x, w)`` as one matrix product."""
    d, h, k = w.shape
    return torch.matmul(x, w.to(x.dtype).reshape(d, h * k)).unflatten(
        -1, (h, k))


def qkv_proj(p, x, positions, rope_theta):
    """x: [B,S,D] -> q [B,S,H,hd], k/v [B,S,Hkv,hd].  The bias is added
    after the projection and before RoPE."""
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    if rope_theta:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    return q, k, v


def out_proj(p, o):
    """``einsum("bshk,hkd->bsd", o, wo)``."""
    h, k, d = p["wo"].shape
    return torch.matmul(o.flatten(-2), p["wo"].to(o.dtype).reshape(h * k, d))


# ---------------------------------------------------------------------------
# prefill attention


def attend(q, k, v, q_offset: int = 0, *, causal=True,
           window: Optional[int] = None, kv_len: Optional[int] = None,
           prefix_len: Optional[int] = None) -> torch.Tensor:
    """q: [B,Sq,H,hd]; k,v: [B,Skv,Hkv,hd] -> [B,Sq,H,hd].

    The JAX package's ``attend(q, k, v, q_pos, kv_pos, causal=, window=,
    kv_mask=, prefix_len=)`` for the positions the LM paths pass: ``q_pos
    = q_offset + arange(Sq)`` and ``kv_pos = arange(Skv)``; keys ``>=
    kv_len`` are padding (a ``kv_mask`` that is ``arange(Skv) < kv_len`` in
    every row, as encdec's padded frames); keys ``< prefix_len`` are seen
    by every query (the vlm's image prefix).  float32 math, masked scores
    at -1e9, output in q's dtype.  k and v may be strided views of a KV
    cache.  Differentiable on both devices (module docstring)."""
    return flash_ops.flash_attention(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset, kv_len=kv_len,
                                     prefix_len=prefix_len)


# ---------------------------------------------------------------------------
# decode (one new token against a cache)


def _decode_partial(q, k, v, kv_pos, length, window):
    """Partial attention over one KV partition.

    q: [B,H,hd]; k,v: [B,C,Hkv,hd]; kv_pos: [C] absolute slot positions;
    length: [B] cache fill.  Returns (m, l, acc): [B,H], [B,H], [B,H,hd].
    """
    B, H, hd = q.shape
    Hkv = k.shape[2]
    group = H // Hkv
    scale = 1.0 / math.sqrt(hd)
    qf = q.reshape(B, Hkv, group, hd).float()
    kf = k.float()
    vf = v.float()
    s = torch.einsum("bhgd,bchd->bhgc", qf, kf) * scale    # [B,Hkv,g,C]
    valid = kv_pos[None, :] < length[:, None]              # [B,C]
    if window is not None:
        valid = valid & (kv_pos[None, :] >= length[:, None] - window)
    vmask = valid[:, None, None, :]
    s = torch.where(vmask, s, NEG)
    m = torch.amax(s, dim=-1)
    p = torch.where(vmask, torch.exp(s - m[..., None]), 0.0)
    l = torch.sum(p, dim=-1)
    acc = torch.einsum("bhgc,bchd->bhgd", p, vf)
    return m.reshape(B, H), l.reshape(B, H), acc.reshape(B, H, hd)


def decode_attend_local(q, k, v, kv_pos, length, window=None):
    """Unsharded decode attention.  q: [B,H,hd] -> [B,H,hd]."""
    m, l, acc = _decode_partial(q, k, v, kv_pos, length, window)
    return (acc / torch.clamp(l[..., None], min=1e-30)).to(q.dtype)


def combine_partials(m, l, acc, mesh, axis: str = "model"):
    """LSE-combine partial attention over mesh axis ``axis`` (the partition
    axis): each partition's ``(m, l, acc)`` are its buffered partial ops,
    exchanged in one all-gather and consolidated on every rank, in
    coordinate order (so every rank gets the same bits): the reference's
    max and two sums (``pmax``, ``psum``) over the gathered partials."""
    parts = mesh.all_gather(torch.cat([m[..., None], l[..., None], acc],
                                      dim=-1), axis)
    m_all, l_all, acc_all = parts[..., 0], parts[..., 1], parts[..., 2:]
    m_g = torch.amax(m_all, dim=0)
    r = torch.exp(m_all - m_g)
    l_g = torch.sum(l_all * r, dim=0)
    acc_g = torch.sum(acc_all * r[..., None], dim=0)
    return acc_g / torch.clamp(l_g[..., None], min=1e-30)


def decode_attend_partitioned(q, k, v, length, mesh, *, window=None,
                              seq_axis: str = "model"):
    """Partitioned-KV decode on one rank of ``mesh``.

    q: [B_loc, H, hd] (the same on every rank of ``seq_axis``); k, v: this
    rank's sequence shard ``[B_loc, S/n, Hkv, hd]``, shard ``i`` holding
    slots ``i*S/n ..`` for ``i`` the rank's ``seq_axis`` coordinate;
    length: [B_loc].  The batch may be sharded over the other axes: each
    rank passes its rows.  Returns [B_loc, H, hd] in q's dtype, the same on
    every rank of ``seq_axis``.
    """
    s_loc = k.shape[1]
    kv_pos = mesh.coords[seq_axis] * s_loc + torch.arange(
        s_loc, device=k.device)
    m, l, acc = _decode_partial(q, k, v, kv_pos, length, window)
    return combine_partials(m, l, acc, mesh, seq_axis).to(q.dtype)


# ---------------------------------------------------------------------------
# KV cache


class KVCache(NamedTuple):
    """Per-layer-stacked cache.  k,v: [L, B, S, Hkv, hd]; length: [B]."""
    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor

    @staticmethod
    def init(n_layers, batch, max_len, n_kv, head_dim, dtype, device=None,
             length: Optional[torch.Tensor] = None):
        shape = (n_layers, batch, max_len, n_kv, head_dim)
        return KVCache(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
            length=(length if length is not None
                    else torch.zeros((batch,), dtype=torch.int32,
                                     device=device)))


def cache_update_local(k_cache, v_cache, k_new, v_new, length):
    """Write one token at position ``length`` (per sequence) — unsharded.

    k_cache: [B,S,Hkv,hd]; k_new: [B,1,Hkv,hd]; length: [B].  Updates the
    caches in place (the JAX package rebuilds them with a one-hot blend,
    ``cache * (1 - onehot) + new * onehot``, which equals this wherever the
    cache is finite) and returns them.  A sequence whose ``length`` is
    outside the cache (past its end, or below 0) writes nothing, as the
    blend's all-zero one-hot row.
    """
    B, S = k_cache.shape[:2]
    rows = torch.arange(B, device=k_cache.device)
    slot = torch.clamp(length.long(), min=0, max=S - 1)
    inside = ((length >= 0) & (length < S))[:, None, None]
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        keep = cache[rows, slot]
        cache.index_put_((rows, slot),
                         torch.where(inside, new[:, 0].to(cache.dtype), keep))
    return k_cache, v_cache


def cache_update_sharded(k_cache, v_cache, k_new, v_new, length, mesh,
                         seq_axis: str = "model"):
    """:func:`cache_update_local` on a sequence shard: k_cache is this
    rank's ``[B, S/n, Hkv, hd]`` of slots ``i*S/n ..`` (``i`` its
    ``seq_axis`` coordinate), and slot ``length`` is written only on the
    rank that owns it; a slot past the whole cache's end is written by
    none."""
    s_loc = k_cache.shape[1]
    local = length - mesh.coords[seq_axis] * s_loc
    return cache_update_local(k_cache, v_cache, k_new, v_new, local)
