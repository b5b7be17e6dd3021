"""Decoder-only LM assembly: prefill and decode of the dense family.

The port of the JAX package's ``repro.models.transformer`` for the
``dense`` family on one device.  Parameters are nested dictionaries with the
JAX package's tree and layouts: ``params["stack"]`` holds every layer's
leaves stacked on a leading ``[L]`` axis, and the layer loops (``lax.scan``
and ``fori_loop`` there) are Python loops over it.  moe, ssm and hybrid
raise ``NotImplementedError`` naming their ROADMAP item; the ``rules`` and
manual-TP arms of the reference (a mesh) have no counterpart here.

Weights are stored as the reference uses them (``storage_dtype``): block
matmul weights and biases in ``cfg.cdtype`` — bit-identical to the
reference's ``cast_layer_params`` casting the float32 master copy at every
use — the embedding table in ``cdtype`` (``embed`` casts before the
gather), and the unembed and every norm in ``cfg.pdtype``: the reference's
decode reads the norms uncast, its prefill through ``cast_layer_params``.

The KV cache is updated in place (the reference rebuilds it functionally);
``decode_step`` consumes the state it is given.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models.attention import KVCache

#: families whose modules wait for a later slice, with their ROADMAP item
_NOT_PORTED = {
    "moe": "moe.py, ROADMAP A14",
    "ssm": "ssm.py, ROADMAP A14",
    "hybrid": "rglru.py and windowed attention, ROADMAP A14",
    "encdec": "encdec.py (whisper), ROADMAP A14",
    "vlm": "the prefix_len mask, ROADMAP A14",
}


def check_family(cfg: ArchConfig) -> None:
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet "
            f"({_NOT_PORTED[cfg.family]}); the port runs the dense family")
    if cfg.family != "dense":
        raise ValueError(f"unknown family {cfg.family!r}")


class DecodeState(NamedTuple):
    kv: Optional[KVCache]                     # [n_attn_layers, ...]
    ssm: Optional[object] = None              # the ssm family (A14)
    lru: Optional[object] = None              # the hybrid family (A14)


def layer_plan(cfg: ArchConfig) -> list:
    check_family(cfg)
    return ["attn"] * cfg.n_layers


# ---------------------------------------------------------------------------
# params

_NORMS = ("ln1", "ln2")


def storage_dtype(path: tuple, cfg: ArchConfig) -> torch.dtype:
    """The dtype a parameter leaf is stored in (see the module docstring):
    ``path`` is its key path, e.g. ``("stack", "attn", "wq")``."""
    if path[0] == "embed":
        if path[-1] == "embedding" and not cfg.tie_embeddings:
            return cfg.cdtype
        return cfg.pdtype
    if path[0] == "final_norm" or path[1] in _NORMS:
        return cfg.pdtype
    return cfg.cdtype


def init_layer(gen: torch.Generator, cfg: ArchConfig, kind: str, device):
    """One layer's parameters in ``cfg.pdtype``, as the reference draws
    them."""
    if kind != "attn":
        raise NotImplementedError(f"layer kind {kind!r} (ROADMAP A14)")
    d, dt = cfg.d_model, cfg.pdtype
    return {"ln1": L.init_norm(dt, d, cfg.norm, device),
            "attn": attn.init_attention(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                        cfg.head_dim_, dt, cfg.qkv_bias,
                                        device),
            "ln2": L.init_norm(dt, d, cfg.norm, device),
            "mlp": L.init_mlp(gen, d, cfg.d_ff, dt, cfg.gated_mlp, device)}


def _stacked_init(gen, cfg, kind, n, device):
    """``n`` layers stacked on a leading axis in their storage dtypes,
    drawn one layer at a time so that only one layer's float32 draws are
    live besides the stack."""
    stack = None
    for i in range(n):
        lp = init_layer(gen, cfg, kind, device)
        if stack is None:
            stack = {g: {k: torch.empty(
                (n,) + t.shape, device=device,
                dtype=storage_dtype(("stack", g, k), cfg))
                for k, t in leaves.items()} for g, leaves in lp.items()}
        for g, leaves in lp.items():
            for k, t in leaves.items():
                stack[g][k][i].copy_(t)
    return stack


def init_params(gen: torch.Generator, cfg: ArchConfig, device) -> dict:
    """Random parameters with the JAX package's scales and layouts, drawn
    from ``gen`` on ``device`` (different numbers from the reference's),
    each leaf in its storage dtype."""
    kind = layer_plan(cfg)[0]
    emb = L.init_embedding(gen, L.pad_vocab(cfg.vocab), cfg.d_model,
                           cfg.pdtype, cfg.tie_embeddings, device)
    return {
        "embed": {k: t.to(storage_dtype(("embed", k), cfg))
                  for k, t in emb.items()},
        "stack": _stacked_init(gen, cfg, kind, cfg.n_layers, device),
        "final_norm": L.init_norm(cfg.pdtype, cfg.d_model, cfg.norm, device),
    }


def _layer(stack: dict, i: int) -> dict:
    """Layer ``i``'s leaves (views into the stacked tensors)."""
    return {g: {k: t[i] for k, t in leaves.items()}
            for g, leaves in stack.items()}


def cast_layer_params(lp: dict, cdtype: torch.dtype) -> dict:
    """Cast a layer's float32 leaves to the compute dtype, as the reference
    does at every full-sequence use: here only the norms are float32 (the
    matmul weights are stored in ``cdtype`` already)."""
    return {g: {k: (t.to(cdtype) if t.dtype == torch.float32 else t)
                for k, t in leaves.items()}
            for g, leaves in lp.items()}


# ---------------------------------------------------------------------------
# layer application (full sequence: prefill)


def _apply_attn_layer(lp, cfg, x, positions):
    """Returns (x, (k, v)): the layer's keys and values fill the cache."""
    h = L.apply_norm(lp["ln1"], x, cfg.norm)
    q, k, v = attn.qkv_proj(lp["attn"], h, positions, cfg.rope_theta)
    o = attn.attend(q, k, v, 0, causal=True)
    return x + attn.out_proj(lp["attn"], o), (k, v)


def _apply_mlp(lp, cfg, x):
    h = L.apply_norm(lp["ln2"], x, cfg.norm)
    return x + L.apply_mlp(lp["mlp"], h, cfg.act)


def _apply_layer_full(lp, cfg, x, positions):
    """One attn layer, full sequence.  Returns (x, (k, v))."""
    lp = cast_layer_params(lp, cfg.cdtype)
    x, kv = _apply_attn_layer(lp, cfg, x, positions)
    return _apply_mlp(lp, cfg, x), kv


# ---------------------------------------------------------------------------
# prefill: forward + build decode state

PREFILL_CHUNK = 4096


def prefill(params, cfg: ArchConfig, tokens, *, max_len=None,
            chunk: int = PREFILL_CHUNK):
    """tokens: [B,S] int.  Returns (last_logits [B,V] f32, DecodeState with
    length = S).

    A prompt longer than ``chunk`` whose length is a multiple of it is
    processed in chunks (``_prefill_chunked``); any other prompt in one
    pass (``_prefill_whole``), as in the reference."""
    check_family(cfg)
    S_tot = tokens.shape[1]
    if S_tot > chunk and S_tot % chunk == 0 and (max_len or S_tot) >= S_tot:
        return _prefill_chunked(params, cfg, tokens, max_len=max_len or S_tot,
                                chunk=chunk)
    return _prefill_whole(params, cfg, tokens, max_len=max_len)


def _final_logits(params, cfg, x_last):
    x = L.apply_norm(params["final_norm"], x_last, cfg.norm)
    return L.unembed(params["embed"], x.float(), cfg.vocab)


def _prefill_chunked(params, cfg: ArchConfig, tokens, *, max_len, chunk):
    """Each chunk attends against the cache filled so far plus itself
    (``attend`` with ``q_offset = off`` on a prefix view of the cache),
    writing its keys and values into the cache in place."""
    x_all = L.embed(params["embed"], tokens, cfg.cdtype)
    B, S_tot, _ = x_all.shape
    cache = KVCache.init(cfg.n_layers, B, max_len, cfg.n_kv_heads,
                         cfg.head_dim_, cfg.cdtype, device=x_all.device)
    kc, vc = cache.k, cache.v
    last_x = None
    for ci in range(S_tot // chunk):
        off = ci * chunk
        x = x_all[:, off:off + chunk]
        q_pos = off + torch.arange(chunk, device=x.device)
        for i in range(cfg.n_layers):
            lp = cast_layer_params(_layer(params["stack"], i), cfg.cdtype)
            h = L.apply_norm(lp["ln1"], x, cfg.norm)
            q, k, v = attn.qkv_proj(lp["attn"], h, q_pos, cfg.rope_theta)
            kc[i, :, off:off + chunk] = k
            vc[i, :, off:off + chunk] = v
            o = attn.attend(q, kc[i, :, :off + chunk], vc[i, :, :off + chunk],
                            off, causal=True)
            x = _apply_mlp(lp, cfg, x + attn.out_proj(lp["attn"], o))
        last_x = x
    last = _final_logits(params, cfg, last_x[:, -1])
    length = torch.full((B,), S_tot, dtype=torch.int32, device=x_all.device)
    return last, DecodeState(kv=KVCache(k=kc, v=vc, length=length))


def _prefill_whole(params, cfg: ArchConfig, tokens, *, max_len=None):
    """One pass over the prompt; each layer's keys and values are written
    into a zero cache of ``max_len`` positions (the reference zero-pads
    them to it; a prompt longer than the cache keeps its last ``max_len``
    positions)."""
    x = L.embed(params["embed"], tokens, cfg.cdtype)
    B, S, _ = x.shape
    max_len = max_len or S
    positions = torch.arange(S, device=x.device)
    cache = KVCache.init(cfg.n_layers, B, max_len, cfg.n_kv_heads,
                         cfg.head_dim_, cfg.cdtype, device=x.device)
    n = min(S, max_len)
    for i in range(cfg.n_layers):
        x, (k, v) = _apply_layer_full(_layer(params["stack"], i), cfg, x,
                                      positions)
        cache.k[i, :, :n] = k[:, S - n:]
        cache.v[i, :, :n] = v[:, S - n:]
    last = _final_logits(params, cfg, x[:, -1])
    length = torch.full((B,), S, dtype=torch.int32, device=x.device)
    return last, DecodeState(kv=cache._replace(length=length))


# ---------------------------------------------------------------------------
# decode (one token)


def _decode_attn_layer(lp, cfg, x, k_cache, v_cache, length):
    """x: [B,1,D].  Returns (x, k_cache, v_cache), the caches updated in
    place."""
    h = L.apply_norm(lp["ln1"], x, cfg.norm)
    q, k, v = attn.qkv_proj(lp["attn"], h, length[:, None], cfg.rope_theta)
    k_cache, v_cache = attn.cache_update_local(k_cache, v_cache, k, v, length)
    kv_pos = torch.arange(k_cache.shape[1], device=x.device)
    o = attn.decode_attend_local(q[:, 0], k_cache, v_cache, kv_pos,
                                 length + 1)
    x = x + attn.out_proj(lp["attn"], o[:, None])
    return x, k_cache, v_cache


def decode_step(params, cfg: ArchConfig, tokens, state: DecodeState):
    """tokens: [B,1].  Returns (logits [B,V] f32, new DecodeState).

    The layers' caches are updated in place (views of the stacked cache),
    so ``state`` is consumed; the new state shares its cache tensors with
    a length one larger."""
    check_family(cfg)
    x = L.embed(params["embed"], tokens, cfg.cdtype)
    kc, vc, length = state.kv
    for i in range(cfg.n_layers):
        lp = _layer(params["stack"], i)
        x, _, _ = _decode_attn_layer(lp, cfg, x, kc[i], vc[i], length)
        x = _apply_mlp(lp, cfg, x)
    logits = _final_logits(params, cfg, x[:, 0])
    return logits, DecodeState(kv=KVCache(k=kc, v=vc, length=length + 1))
