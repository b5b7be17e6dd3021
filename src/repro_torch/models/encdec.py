"""Whisper-style encoder-decoder backbone: the training forward, prefill
and decode.

The port of the JAX package's ``repro.models.encdec`` on one device.  The
conv audio frontend is a stub, as in the reference: a request brings
precomputed frame embeddings ``[B, F, d_model]`` (F = 1500 for 30 s of
audio at 50 Hz after the convolutions).  Both stacks use sinusoidal
positions and no RoPE.

The reference pads the frames to ``N_FRAMES_PAD`` and masks the padded
ones with a ``kv_mask [B, F_pad]`` that is ``arange(F_pad) < F`` in every
row; here that mask is the flash kernel's ``kv_len = F``: the encoder's
self-attention and the prefill's cross-attention are non-causal over
``F_pad`` keys of which the first F are seen.  Decode's cross-attention
reads ``min(N_FRAMES, F_pad)`` slots of the static cross cache whatever F
is, as the reference's does (ROADMAP C7: with F < 1500 a decode reads the
encoder's outputs at padded frames that its prefill masked).

Weights are stored as the reference uses them: it casts each matmul weight
to the compute dtype at its use and reads the norms uncast in encode,
prefill and decode alike.  So the matmul weights are stored in ``cdtype``
(bit-identical to that cast) and the norms ``ln1``, ``ln2``, ``ln_x``,
``enc_norm`` and ``final_norm`` in ``pdtype``
(``transformer.storage_dtype``); the tied embedding stays in ``pdtype``.

Decode state: the decoder's self-attention KV cache (``max_len`` slots,
updated in place) and the cross-attention keys and values of the encoder's
memory, projected once at prefill.

On a mesh (``rules``) every attention block and MLP runs tensor parallel
(``models/manual_tp.py``), as in ``models/transformer.py``; a
self-attention block whose queries the reference shards on their
sequence (``"seq"``: the encoder over its padded frames, the decoder's
prefill) runs on the rank's query rows, the cross-attention never: the
self-attention cache is sharded over ``"model"`` on its sequence axis
(decode: ``decode_attend_partitioned``), the cross cache keeps every frame
and every kv head on every rank (the reference's ``state_logical_axes``:
``"null"``), and the cross-attention of a decode step runs on the rank's
heads.  The training forward gathers each layer's FSDP shards inside its
recomputed body, so the remat gathers them again rather than keeping
every layer's whole weights.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import manual_tp as tp_lib
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import KVCache
from repro_torch.models.sharding import batch_rows

N_FRAMES = 1500       # whisper: 30 s @ 50 Hz post-conv
N_FRAMES_PAD = 1536   # the reference pads the frames to a multiple of 16;
#                       padded positions are masked out of the encoder's
#                       self-attention and the prefill's cross-attention


class EncDecState(NamedTuple):
    self_kv: KVCache         # [L, B, max_len, Hkv, hd]
    cross_k: torch.Tensor    # [L, B, F_pad, Hkv, hd]
    cross_v: torch.Tensor


# ---------------------------------------------------------------------------
# sinusoidal positions


def _exp_f32(x: np.ndarray) -> np.ndarray:
    """float32 ``exp`` as the JAX package computes it on the CPU, bit for
    bit: the Cephes polynomial with fused multiply-adds (each emulated in
    float64 and rounded once).  A correctly rounded exp differs from it by
    an ulp at some arguments, and the angle ``position * freq`` multiplies
    that by up to 1,535 positions (1.2e-4 in the table at d = 512)."""
    f, d = np.float32, np.float64

    def fma(a, b, c):
        return (np.asarray(a, d) * np.asarray(b, d) + np.asarray(c, d)
                ).astype(f)

    x = np.clip(np.asarray(x, f), f(-88.3762626647950), f(88.3762626647949))
    fx = np.floor(x * f(1.44269504088896341) + f(0.5))
    x = fma(-fx, f(0.693359375), x)
    x = fma(-fx, f(-2.12194440e-4), x)
    z = x * x
    y = f(1.9875691500e-4)
    for c in (1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
              1.6666665459e-1, 5.0000001201e-1):
        y = fma(y, x, f(c))
    y = fma(y, z, x) + f(1.0)
    return (y * np.exp2(fx)).astype(f)


@functools.lru_cache(maxsize=None)
def _freqs(d: int) -> np.ndarray:
    half = d // 2
    f = np.float32
    arg = f(-np.log(10000.0)) * np.arange(half, dtype=f) / f(max(half - 1, 1))
    return _exp_f32(arg)


def sinusoidal(positions: torch.Tensor, d: int) -> torch.Tensor:
    """positions: [...] int -> [..., d] float32, ``[sin(p f), cos(p f)]``
    with ``f = exp(-log(10000) arange(d/2) / (d/2 - 1))``.  The frequencies
    are made on the host (``_exp_f32``), so the card and the CPU use the
    same ones."""
    freqs = torch.from_numpy(_freqs(d)).to(positions.device)
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# params


def _enc_layer(gen, cfg: ArchConfig, device) -> dict:
    d, dt = cfg.d_model, cfg.pdtype
    return {"ln1": L.init_norm(dt, d, cfg.norm, device),
            "attn": attn.init_attention(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                        cfg.head_dim_, dt, device=device),
            "ln2": L.init_norm(dt, d, cfg.norm, device),
            "mlp": L.init_mlp(gen, d, cfg.d_ff, dt, cfg.gated_mlp, device)}


def _dec_layer(gen, cfg: ArchConfig, device) -> dict:
    lp = _enc_layer(gen, cfg, device)
    lp["ln_x"] = L.init_norm(cfg.pdtype, cfg.d_model, cfg.norm, device)
    lp["xattn"] = attn.init_attention(gen, cfg.d_model, cfg.n_heads,
                                      cfg.n_kv_heads, cfg.head_dim_,
                                      cfg.pdtype, device=device)
    return lp


def param_axes(cfg: ArchConfig) -> dict:
    """The reference's logical axes tree of :func:`init_encdec`'s params,
    leaf for leaf."""
    enc = {"ln1": L.norm_axes(cfg.norm), "attn": attn.attention_axes(),
           "ln2": L.norm_axes(cfg.norm), "mlp": L.mlp_axes(cfg.gated_mlp)}
    dec = dict(enc, ln_x=L.norm_axes(cfg.norm), xattn=attn.attention_axes())
    return {"embed": L.embedding_axes(cfg.tie_embeddings),
            "encoder": L.add_layer_axis(enc),
            "decoder": L.add_layer_axis(dec),
            "enc_norm": L.norm_axes(cfg.norm),
            "final_norm": L.norm_axes(cfg.norm)}


def _layer_axes(cfg, stack: str) -> dict:
    """One layer's axes of ``stack`` (without the ``"layers"`` axis)."""
    return {g: {k: a[1:] for k, a in leaves.items()}
            for g, leaves in param_axes(cfg)[stack].items()}


def init_encdec(gen: torch.Generator, cfg: ArchConfig, device,
                train: bool = False) -> dict:
    """Random parameters with the JAX package's tree, scales and layouts
    (``embed``; ``encoder`` and ``decoder`` stacked on ``[L]``, a decoder
    layer with ``ln_x`` and ``xattn``; ``enc_norm``, ``final_norm``),
    drawn from ``gen`` on ``device``, each leaf in its storage dtype
    (``train``: the reference's, ``transformer.storage_dtype``)."""
    d = cfg.d_model
    emb = L.init_embedding(gen, L.pad_vocab(cfg.vocab), d, cfg.pdtype,
                           cfg.tie_embeddings, device)
    return {
        "embed": {k: t.to(tfm.storage_dtype(("embed", k), cfg, train))
                  for k, t in emb.items()},
        "encoder": tfm.stacked_init(lambda: _enc_layer(gen, cfg, device),
                                    cfg, cfg.n_enc_layers or cfg.n_layers,
                                    device, ("encoder",), train),
        "decoder": tfm.stacked_init(lambda: _dec_layer(gen, cfg, device),
                                    cfg, cfg.n_layers, device, ("decoder",),
                                    train),
        "enc_norm": L.init_norm(cfg.pdtype, d, cfg.norm, device),
        "final_norm": L.init_norm(cfg.pdtype, d, cfg.norm, device),
    }


# ---------------------------------------------------------------------------
# blocks


def _self_block(lp, cfg, x, causal, kv_len=None, rules=None):
    """Self-attention.  Returns (x, (k, v)): with ``rules`` tensor
    parallel or on the rank's query rows (``manual_tp.manual_attention``),
    the keys and values with the kv heads the rank holds
    (``manual_tp.project``)."""
    h = L.apply_norm(lp["ln1"], x, cfg.norm)
    if rules is not None:
        y, k, v = tp_lib.manual_attention(lp["attn"], h, None, cfg, rules,
                                          theta=0.0, causal=causal,
                                          kv_len=kv_len)
        return x + y, (k, v)
    q, k, v = attn.qkv_proj(lp["attn"], h, None, 0.0)
    o = attn.attend(q, k, v, 0, causal=causal, kv_len=kv_len)
    return x + attn.out_proj(lp["attn"], o), (k, v)


def _cross_block(lp, cfg, x, memory, kv_len, rules=None):
    """Cross-attention against the encoder's memory.  Returns (x, (k, v)):
    with ``rules`` on the rank's heads, and the keys and values with every
    kv head (``manual_tp.all_heads``), as the cross cache holds them."""
    h = L.apply_norm(lp["ln_x"], x, cfg.norm)
    xa = lp["xattn"]
    if rules is not None:
        lay = tp_lib.attn_layout(cfg, rules)
        y, k, v = tp_lib.manual_attention(xa, h, None, cfg, rules, theta=0.0,
                                          causal=False, kv_len=kv_len,
                                          x_kv=memory)
        return x + y, (tp_lib.all_heads(k, rules, lay),
                       tp_lib.all_heads(v, rules, lay))
    q = attn._proj(h, xa["wq"])
    k, v = attn._proj(memory, xa["wk"]), attn._proj(memory, xa["wv"])
    o = attn.attend(q, k, v, 0, causal=False, kv_len=kv_len)
    return x + attn.out_proj(xa, o), (k, v)


def _mlp_block(lp, cfg, x, rules=None):
    h = L.apply_norm(lp["ln2"], x, cfg.norm)
    if rules is not None:
        return x + tp_lib.manual_mlp(lp["mlp"], h, cfg, rules)
    return x + L.apply_mlp(lp["mlp"], h, cfg.act)


def _layers(params, cfg, stack: str, rules):
    """Each layer of ``stack`` (views), its FSDP split gathered with
    ``rules``."""
    axes = _layer_axes(cfg, stack) if rules is not None else None
    return [tfm.gather_fsdp(lp, axes, cfg, rules)
            for lp in tfm.unstack(params[stack])]


def _top(params, name, cfg, rules):
    return tfm.gather_fsdp(params[name], L.norm_axes(cfg.norm), cfg, rules)


def pad_frames(frames: torch.Tensor):
    """[B,F,D] -> ([B,F_pad,D] zero-padded to ``N_FRAMES_PAD``, F): the
    padded frames are keys ``>= F``, masked by ``kv_len = F``."""
    F = frames.shape[1]
    if F < N_FRAMES_PAD:
        frames = torch.nn.functional.pad(frames, (0, 0, 0, N_FRAMES_PAD - F))
    return frames, F


def encode(params, cfg: ArchConfig, frames, remat=False, rules=None):
    """frames: [B,F,D] stub embeddings -> (memory [B,F_pad,D] in
    ``cdtype``, F).  ``remat`` recomputes each layer in the backward;
    ``rules`` runs each layer tensor parallel."""
    x, F = pad_frames(frames.to(cfg.cdtype))
    pos = torch.arange(x.shape[1], device=x.device)
    x = x + sinusoidal(pos, cfg.d_model).to(x.dtype)[None]

    axes = _layer_axes(cfg, "encoder") if rules is not None else None

    def body(x, lp):
        lp = tfm.gather_fsdp(lp, axes, cfg, rules)
        x, _ = _self_block(lp, cfg, x, causal=False, kv_len=F, rules=rules)
        return _mlp_block(lp, cfg, x, rules)
    body = tfm.checkpointed(body, remat)
    for lp in tfm.unstack(params["encoder"]):
        x = body(x, lp)
    return L.apply_norm(_top(params, "enc_norm", cfg, rules), x,
                        cfg.norm), F


def forward(params, cfg: ArchConfig, tokens, frames, remat=True,
            rules=None):
    """The training forward.  tokens: [B,S] int; frames: [B,F,D].  Returns
    (logits [B,S,V] float32, a float32 zero: encdec has no aux loss).  The
    padded frames are masked in the encoder and the cross-attention as in
    prefill (``kv_len = F``); each layer is recomputed in the backward
    under ``remat``.  With ``rules``: the rank's rows, tensor parallel."""
    if rules is not None:
        rows = batch_rows(tokens.shape[0], rules)
        tokens, frames = tokens[rows], frames[rows]
    memory, F = encode(params, cfg, frames, remat, rules)
    x = L.embed(params["embed"], tokens, cfg.cdtype, rules, cfg.vocab)
    S = x.shape[1]
    x = x + sinusoidal(torch.arange(S, device=x.device), cfg.d_model).to(
        x.dtype)[None]

    axes = _layer_axes(cfg, "decoder") if rules is not None else None

    def body(x, lp, memory):
        lp = tfm.gather_fsdp(lp, axes, cfg, rules)
        x, _ = _self_block(lp, cfg, x, causal=True, rules=rules)
        x, _ = _cross_block(lp, cfg, x, memory, F, rules)
        return _mlp_block(lp, cfg, x, rules)
    body = tfm.checkpointed(body, remat)
    for lp in tfm.unstack(params["decoder"]):
        x = body(x, lp, memory)
    logits = tfm.final_logits(params, cfg, x, rules)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


# ---------------------------------------------------------------------------
# serving


def prefill(params, cfg: ArchConfig, tokens, frames, *,
            max_len: Optional[int] = None, rules=None):
    """tokens: [B,S] int; frames: [B,F,D].  Returns (last_logits [B,V]
    f32, EncDecState with ``length = S``): a self-attention cache of
    ``max(max_len, S)`` slots (the reference keeps the whole prompt when it
    is longer) and the cross cache of the encoder's ``F_pad`` frames.
    With ``rules``: :func:`_prefill_sharded`."""
    if rules is not None:
        return _prefill_sharded(params, cfg, tokens, frames,
                                max(max_len or tokens.shape[1],
                                    tokens.shape[1]), rules)
    memory, F = encode(params, cfg, frames)
    x = L.embed(params["embed"], tokens, cfg.cdtype)
    B, S = tokens.shape
    dev = x.device
    x = x + sinusoidal(torch.arange(S, device=dev), cfg.d_model).to(
        x.dtype)[None]
    Ln, Hkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim_
    self_kv = KVCache.init(Ln, B, max(max_len or S, S), Hkv, hd, cfg.cdtype,
                           device=dev)
    cross = torch.empty((2, Ln, B, memory.shape[1], Hkv, hd),
                        dtype=cfg.cdtype, device=dev)
    for i in range(Ln):
        lp = tfm._layer(params["decoder"], i)
        x, (k, v) = _self_block(lp, cfg, x, causal=True)
        self_kv.k[i, :, :S] = k
        self_kv.v[i, :, :S] = v
        x, (xk, xv) = _cross_block(lp, cfg, x, memory, F)
        cross[0, i] = xk
        cross[1, i] = xv
        x = _mlp_block(lp, cfg, x)
    last = tfm.final_logits(params, cfg, x[:, -1])
    length = torch.full((B,), S, dtype=torch.int32, device=dev)
    return last, EncDecState(self_kv=self_kv._replace(length=length),
                             cross_k=cross[0], cross_v=cross[1])


def _prefill_sharded(params, cfg: ArchConfig, tokens, frames, C: int,
                     rules):
    """The prefill on a mesh: the rank's rows, every block tensor parallel;
    the self cache of ``C`` slots the rank's sequence shard with every kv
    head, the cross cache whole."""
    tfm.check_seq_shards(C, rules)
    rows = batch_rows(tokens.shape[0], rules)
    tokens, frames = tokens[rows], frames[rows]
    memory, F = encode(params, cfg, frames, rules=rules)
    x = L.embed(params["embed"], tokens, cfg.cdtype, rules, cfg.vocab)
    B, S = tokens.shape
    dev = x.device
    x = x + sinusoidal(torch.arange(S, device=dev), cfg.d_model).to(
        x.dtype)[None]
    lay = tp_lib.attn_layout(cfg, rules, (B, S))
    self_kv, cross = ([], []), ([], [])
    for lp in _layers(params, cfg, "decoder", rules):
        x, (k, v) = _self_block(lp, cfg, x, causal=True, rules=rules)
        for dst, t in zip(self_kv, (k, v)):
            t = torch.nn.functional.pad(t, (0, 0, 0, 0, 0, C - S))
            dst.append(tp_lib.seq_shard(t, rules, lay, S))
        x, xkv = _cross_block(lp, cfg, x, memory, F, rules)
        for dst, t in zip(cross, xkv):
            dst.append(t)
        x = _mlp_block(lp, cfg, x, rules)
    last = tfm.final_logits(params, cfg, x[:, -1], rules)
    length = torch.full((B,), S, dtype=torch.int32, device=dev)
    k, v = (torch.stack(t) for t in self_kv)
    return last, EncDecState(self_kv=KVCache(k=k, v=v, length=length),
                             cross_k=torch.stack(cross[0]),
                             cross_v=torch.stack(cross[1]))


def decode_step(params, cfg: ArchConfig, tokens, state: EncDecState, *,
                mesh=None, rules=None):
    """tokens: [B,1] -> (logits [B,V] f32, state).  The self-attention
    cache is updated in place (``state`` is consumed); the cross-attention
    reads ``min(N_FRAMES, F_pad)`` slots of the cross cache, as the
    reference (ROADMAP C7).  With ``rules`` (and its ``mesh``): the rank's
    rows, the self-attention on its sequence shard
    (``manual_tp.decode_attention``), the cross-attention and the MLP on
    its heads and columns."""
    rules = tfm.sharded_rules(mesh, rules)
    if rules is not None:
        return _decode_sharded(params, cfg, tokens, state, rules)
    x = L.embed(params["embed"], tokens, cfg.cdtype)
    kc, vc, length = state.self_kv
    xk, xv = state.cross_k, state.cross_v
    B, dev = tokens.shape[0], x.device
    x = x + sinusoidal(length[:, None], cfg.d_model).to(x.dtype)
    self_pos = torch.arange(kc.shape[2], device=dev)
    cross_pos = torch.arange(xk.shape[2], device=dev)
    cross_len = torch.full((B,), min(N_FRAMES, xk.shape[2]),
                           dtype=torch.int32, device=dev)
    for i in range(cfg.n_layers):
        lp = tfm._layer(params["decoder"], i)
        h = L.apply_norm(lp["ln1"], x, cfg.norm)
        q, k, v = attn.qkv_proj(lp["attn"], h, None, 0.0)
        attn.cache_update_local(kc[i], vc[i], k, v, length)
        o = attn.decode_attend_local(q[:, 0], kc[i], vc[i], self_pos,
                                     length + 1)
        x = x + attn.out_proj(lp["attn"], o[:, None])
        # cross-attention against the static memory projections
        h = L.apply_norm(lp["ln_x"], x, cfg.norm)
        q = attn._proj(h, lp["xattn"]["wq"])
        o = attn.decode_attend_local(q[:, 0], xk[i], xv[i], cross_pos,
                                     cross_len)
        x = x + attn.out_proj(lp["xattn"], o[:, None])
        x = _mlp_block(lp, cfg, x)
    logits = tfm.final_logits(params, cfg, x[:, 0])
    return logits, state._replace(
        self_kv=KVCache(k=kc, v=vc, length=length + 1))


def state_specs(cfg: ArchConfig, batch: int, max_len: int,
                dtype) -> EncDecState:
    """The decode state's ``(shape, dtype)`` pairs, in its tree: the cross
    cache holds ``N_FRAMES_PAD`` frames."""
    kv = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim_)
    xs = (cfg.n_layers, batch, N_FRAMES_PAD, cfg.n_kv_heads, cfg.head_dim_)
    return EncDecState(
        self_kv=KVCache(k=(kv, dtype), v=(kv, dtype),
                        length=((batch,), torch.int32)),
        cross_k=(xs, dtype), cross_v=(xs, dtype))


def _decode_sharded(params, cfg: ArchConfig, tokens, state: EncDecState,
                    rules):
    kc, vc, length = state.self_kv
    xk, xv = state.cross_k, state.cross_v
    tokens = tokens[batch_rows(tokens.shape[0], rules)]
    x = L.embed(params["embed"], tokens, cfg.cdtype, rules, cfg.vocab)
    B, dev = tokens.shape[0], x.device
    x = x + sinusoidal(length[:, None], cfg.d_model).to(x.dtype)
    cross_pos = torch.arange(xk.shape[2], device=dev)
    cross_len = torch.full((B,), min(N_FRAMES, xk.shape[2]),
                           dtype=torch.int32, device=dev)
    lay = tp_lib.attn_layout(cfg, rules)
    heads = slice(lay.kv0, lay.kv0 + lay.kv_loc)
    for i, lp in enumerate(_layers(params, cfg, "decoder", rules)):
        h = L.apply_norm(lp["ln1"], x, cfg.norm)
        x = x + tp_lib.decode_attention(lp["attn"], h, kc[i], vc[i], length,
                                        cfg, rules, theta=0.0)
        # cross-attention of the rank's heads against the whole cross cache
        h = L.apply_norm(lp["ln_x"], x, cfg.norm)
        p = tp_lib.attn_weights(lp["xattn"], cfg, rules, lay)
        q = attn._proj(h, p["wq"])
        o = attn.decode_attend_local(q[:, 0], xk[i][:, :, heads],
                                     xv[i][:, :, heads], cross_pos,
                                     cross_len)
        x = x + tp_lib.out_tp(p, o[:, None], rules, lay, x.dtype)
        x = _mlp_block(lp, cfg, x, rules)
    logits = tfm.final_logits(params, cfg, x[:, 0], rules)
    return logits, state._replace(
        self_kv=KVCache(k=kc, v=vc, length=length + 1))
