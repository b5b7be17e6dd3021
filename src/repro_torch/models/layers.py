"""Shared layers for the LM stack: norms, RoPE, embeddings, (gated) MLP.

The port of the JAX package's ``repro.models.layers``.  Parameters are plain
dictionaries of tensors; every ``init_*`` draws from an explicit
``torch.Generator`` on an explicit device with the JAX package's scales and
layouts (the random numbers differ: the tests carry the JAX package's
weights across with ``convert.lm_params_from_arrays``).  Each
``*_axes`` function gives the reference's logical axes of the leaves its
``init_*`` draws (``models/sharding.py``).  With ``rules``, ``embed`` and
``unembed`` read a rank's block of the table: when its vocab dim is shorter
than the padded vocab, the rank's rows (or columns) of it, combined over
the ``"model"`` axis of the rules' mesh; else the whole table.  Under
autograd their collectives carry the adjoints of ``launch/mesh.py``: the
embed's sum passes the gradient through, the unembed's input sums its
gradient over the vocab's axis and its gathered logits hand each rank its
columns' gradient.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.sharding import gather_dims

# ---------------------------------------------------------------------------
# init helpers


def _normal(gen, shape, dtype, scale, device):
    """``scale * N(0, 1)`` drawn in float32, then cast to ``dtype`` (as the
    JAX package's ``_normal``)."""
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return x.mul_(scale).to(dtype)


# ---------------------------------------------------------------------------
# norms


def norm_axes(kind="rmsnorm") -> dict:
    a = {"scale": ("embed",)}
    if kind == "layernorm":
        a["bias"] = ("embed",)
    return a


def init_norm(dtype, d, kind="rmsnorm", device=None):
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def apply_norm(p, x, kind="rmsnorm", eps=1e-6):
    """RMSNorm or LayerNorm in float32 with ``eps = 1e-6`` (not torch's
    default), the result cast back to ``x``'s dtype."""
    xf = x.float()
    if kind == "rmsnorm":
        n = xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + eps)
        return (n * p["scale"].float()).to(x.dtype)
    mu = torch.mean(xf, -1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), -1, keepdim=True)
    n = (xf - mu) * torch.rsqrt(var + eps)
    out = n * p["scale"].float() + p["bias"].float()
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embedding


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """``1 / theta ** (arange(0, hd, 2) / hd)`` in float32.  The base is a
    Python scalar: a device tensor made from it would be a host-to-device
    copy, which makes the host wait for the card at every call."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(theta, exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, hd]; positions: broadcastable to [..., S].

    Rotates the two split halves of the head (not interleaved pairs), with
    the angles computed in float32 from ``positions``."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # [hd/2]
    ang = positions[..., None].float() * freqs             # [..., S, hd/2]
    cos = torch.cos(ang)[..., None, :]                     # [..., S, 1, hd/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# embedding / unembedding


def embedding_axes(tie=False) -> dict:
    # rows sharded over "model", D replicated: a row-sharded table gathers
    # with local masking and one small all-reduce
    a = {"embedding": ("vocab", "vocab_embed")}
    if not tie:
        a["unembed"] = ("embed", "vocab")
    return a


def init_embedding(gen, vocab, d, dtype, tie=False, device=None):
    p = {"embedding": _normal(gen, (vocab, d), dtype, 1.0, device)}
    if not tie:
        p["unembed"] = _normal(gen, (d, vocab), dtype, 1.0 / math.sqrt(d),
                               device)
    return p


def _vocab_split(n: int, vocab, rules) -> bool:
    """Whether a vocab dim of local length ``n`` is this rank's block of a
    split one: shorter than the padded ``vocab`` (the spec guard leaves a
    dim either whole or evenly split, as ``sharding.gather_dims`` reads
    it)."""
    return rules is not None and vocab is not None and n < pad_vocab(vocab)


def embed(p, tokens, cdtype, rules=None, vocab=None):
    """Token embedding lookup, the table cast to ``cdtype`` first.  Through
    ``F.embedding``, whose backward sums each id's rows in a fixed order
    on the card (an index's backward, an accumulating ``index_put_``, adds
    them with atomics in no fixed order: a training step would not repeat
    itself bit for bit).

    With ``rules`` and a table shorter than ``pad_vocab(vocab)``,
    ``p["embedding"]`` is this rank's block of rows: each rank looks up the
    ids it owns, zeroes the others, and one float32 all-reduce over the
    vocab's mesh axis adds the rows up (exact: one rank adds a non-zero
    row)."""
    table = p["embedding"]
    if not _vocab_split(table.shape[0], vocab, rules):
        return F.embedding(tokens, table.to(cdtype))
    ax = rules.rules["vocab"]
    v_loc = table.shape[0]
    loc = tokens - rules.mesh.coords[ax] * v_loc
    ok = (loc >= 0) & (loc < v_loc)
    x = F.embedding(torch.clamp(loc, 0, v_loc - 1), table.to(cdtype))
    x = x * ok[..., None].to(cdtype)
    return rules.mesh.all_reduce_sum(x.float(), ax).to(cdtype)


def unembed(p, x, true_vocab=None, rules=None):
    """``x @ unembed`` in ``x``'s dtype (float32 on the serving path); the
    padded vocab columns are masked to -1e9, so they can never win.  With
    ``rules`` the weight is this rank's block (its ``"embed"`` rows under
    FSDP, gathered first); when it holds fewer columns than
    ``pad_vocab(true_vocab)``, the rank's logits are all-gathered over the
    vocab's mesh axis into ``[..., V]``."""
    w = p.get("unembed")
    if w is None:
        w = p["embedding"].T
    elif rules is not None:
        w = gather_dims(w, ("embed", "vocab"), rules, {"embed": x.shape[-1]})
    split = _vocab_split(w.shape[-1], true_vocab, rules)
    if split:
        # x is replicated over the vocab's axis and each rank reads it for
        # its own columns: its gradient is the sum of theirs
        x = rules.mesh.sum_grad(x, rules.rules["vocab"])
    logits = torch.matmul(x, w.to(x.dtype))
    if split:
        ax = rules.rules["vocab"]
        logits = torch.cat(list(rules.mesh.all_gather(logits, ax)), dim=-1)
    if true_vocab is not None and true_vocab < logits.shape[-1]:
        mask = torch.arange(logits.shape[-1], device=x.device) < true_vocab
        logits = logits.masked_fill(~mask, -1e9)
    return logits


# ---------------------------------------------------------------------------
# MLP (SwiGLU-gated or plain)


def mlp_axes(gated=True) -> dict:
    a = {"wi": ("embed", "mlp")}
    if gated:
        a["wg"] = ("embed", "mlp")
    a["wo"] = ("mlp", "embed")
    return a


def init_mlp(gen, d, d_ff, dtype, gated=True, device=None):
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(d_ff)
    p = {"wi": _normal(gen, (d, d_ff), dtype, s_in, device)}
    if gated:
        p["wg"] = _normal(gen, (d, d_ff), dtype, s_in, device)
    p["wo"] = _normal(gen, (d_ff, d), dtype, s_out, device)
    return p


def _act(x, act):
    # jax.nn.gelu defaults to the tanh approximation; torch's to the exact
    # erf form
    return F.silu(x) if act == "silu" else F.gelu(x, approximate="tanh")


def apply_mlp(p, x, act="silu"):
    h = torch.matmul(x, p["wi"].to(x.dtype))
    h = _act(h, act)
    if "wg" in p:
        h = h * torch.matmul(x, p["wg"].to(x.dtype))
    return torch.matmul(h, p["wo"].to(x.dtype))


# ---------------------------------------------------------------------------
# misc


def pad_vocab(vocab: int, multiple: int = 256) -> int:
    return int(-(-vocab // multiple) * multiple)


def add_layer_axis(axes):
    """Prefix every logical-axes tuple of a tree with the stacked
    ``"layers"`` axis."""
    if isinstance(axes, dict):
        return {k: add_layer_axis(v) for k, v in axes.items()}
    return ("layers",) + axes
