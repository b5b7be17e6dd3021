"""Tensor-parallel blocks on a ``(data, model)`` mesh, written out.

The port of the JAX package's ``repro.models.manual_tp``.  The reference
has two ways to run a layer on a mesh that compute the same function:
GSPMD's automatic partitioning of the unsharded code, and these manual
(``shard_map``) blocks, enabled by ``rules["manual_tp"]``.  The port has
no compiler to partition for it, so it writes the partitioning out once,
here, and every sharded path uses it (``rules["manual_tp"]`` selects
nothing different in the port).  With the ``"model"`` axis of size ``tp``:

    mlp:   h_loc = act(x @ wi_loc) [* x @ wg_loc]   (F sharded; no comm)
           y     = all_reduce_sum(h_loc @ wo_loc)    (float32)
    attn:  q_loc = x @ wq_loc                        (the rank's H/tp heads)
           k, v  for the kv heads those heads read
           o_loc = attend(q_loc, k, v)               (B6 on the rank's heads)
           y     = all_reduce_sum(o_loc @ wo_loc)    (float32)

The weights a block gets are the rank's blocks by the rules, with any
FSDP (``"data"``) split already gathered by the caller.  The kv heads come
one of two ways (:class:`AttnLayout`): the kv heads are sharded
(``Hkv % tp == 0``); else the kv weights, which the rules leave whole on
every rank, project every kv head, and the rank's q heads read the kv
group slice ``start = idx·h_loc·Hkv // H``.  The reference has a third
way for ``hd % tp == 0``, which splits the head dim of the kv projection
and all-gathers the keys and values over it; it computes the same keys
and values with one more collective a layer, so the port projects them
whole there too.

Where the reference shards the queries of a whole-sequence step on their
sequence over ``"model"`` (its context-parallel ``"seq"`` policy: the
rules map ``"seq"`` to ``"model"`` where the heads do not divide the axis,
and the q spec ``("batch", "seq", "act_heads", None)`` takes the axis when
it divides the step's length), the layer runs the ``"seq"`` layout: every
rank gathers the whole weights, projects the keys and values of the whole
input with every kv head, and runs every head on its contiguous block of
query rows ``[i·S/tp, (i+1)·S/tp)`` (B6 at ``q_offset + i·S/tp``); its
rows of the output projection are all-gathered over ``"model"`` along the
sequence, in the activation dtype (each row comes from one rank: no sum).

    seq:   q_i   = rope(x[rows_i] @ wq)              (every head)
           k, v  = x @ wk, x @ wv                    (every kv head)
           y     = all_gather(attend(q_i, k, v) @ wo) (along the sequence)

Any other block that is not eligible (``attn_eligible`` / ``mlp_eligible``:
the heads or the MLP width do not split over the model axis, or the rank's
q heads would straddle kv groups; or a length the axis does not divide) is
computed replicated from its whole weights (``"full"``), gathered over
every axis that splits them: the reference's spec guard leaves such dims
replicated.  Decode (one token) and cross-attention (which the reference
does not constrain) never take ``"seq"``.

Under autograd (training, ``transformer.forward(rules=)``) every
activation replicated over ``"model"`` keeps a complete, replicated
gradient, so each rank's weight gradients are complete over the model
axis (and partial over ``"data"``, whose rows differ).  The collectives'
adjoints (``launch/mesh.py``) do it: the row-parallel sum passes its
gradient through; an input read for the rank's heads or columns only
sums its gradient over the model axis (``Mesh.sum_grad`` in
:func:`manual_mlp` and :func:`project`); a slice of whole keys sums its
scattered gradient (:func:`group`); weights gathered over the model axis
for a block every rank repeats (``"full"``, a non-eligible MLP) take
their block of the gradient, unsummed.  Under ``"seq"`` a rank's
contribution to every term covers its query rows only, so every gradient
is partial over ``"model"``: the block's input sums its gradient
(``Mesh.sum_grad``), each gathered weight sums its gradient in float32
before the gather's adjoint takes the rank's block, and the output's
gather takes the rank's rows of the complete gradient of the replicated
output (``all_gather(grad="slice")``).

The decode step projects q, k and v the same way, all-gathers them over
``"model"`` in one call (every rank attends over its sequence shard of the
cache with every head: ``attention.decode_attend_partitioned``), and runs
the row-parallel output projection on the rank's heads.  The hybrid's
ring cache is not split on its sequence (the reference's ``"null"``), so
its decode (:func:`decode_attention_ring`) attends the rank's heads over
the whole ring every rank holds, with no gather of q.

The recurrent blocks (``models/ssm.py``, ``models/rglru.py``) run channel
parallel where the model axis splits their ``"inner"`` channels
(:func:`inner_split`): column-parallel input projections, channel-local
conv, gates and scan, a row-parallel output projection summed in float32
(:func:`row_sum`); the Mamba block's ``in_proj`` reaches the rank's
channels through :func:`xz_channels`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L
from repro_torch.models.sharding import gather_dims, spec_axes

AXIS = "model"
#: the logical axes of the queries ``[B, S, H, hd]`` of a whole-sequence
#: step: the reference's constraint of q
Q_AXES = ("batch", "seq", "act_heads", None)


def tp_size(rules) -> int:
    """The model axis's size (1 without rules or without the axis)."""
    return 1 if rules is None else rules._sizes.get(AXIS, 1)


def mlp_eligible(cfg, rules) -> bool:
    tp = tp_size(rules)
    return tp > 1 and cfg.d_ff % tp == 0


def attn_eligible(cfg, rules) -> bool:
    tp = tp_size(rules)
    if tp <= 1 or cfg.n_heads % tp:
        return False
    h_loc = cfg.n_heads // tp
    g = cfg.n_heads // cfg.n_kv_heads
    # per-shard q heads must align with whole kv-head groups
    return (cfg.n_kv_heads % tp == 0) or \
        (tp % cfg.n_kv_heads == 0 and g % h_loc == 0)


# ---------------------------------------------------------------------------
# MLP


def manual_mlp(lp, x, cfg, rules):
    """x: [B,S,D] -> [B,S,D], the MLP on the rank's d_ff columns (its
    blocks of ``wi``/``wg`` and rows of ``wo``), summed over the model
    axis in float32.  Not eligible: the whole MLP, its weights gathered."""
    if not mlp_eligible(cfg, rules):
        full = {"embed": cfg.d_model, "mlp": cfg.d_ff}
        axes = L.mlp_axes("wg" in lp)
        lp = {k: gather_dims(t, axes[k], rules, full) for k, t in lp.items()}
        return L.apply_mlp(lp, x, cfg.act)
    y = L.apply_mlp(lp, rules.mesh.sum_grad(x, AXIS), cfg.act)
    return row_sum(y, rules, x.dtype)


def row_sum(y, rules, dtype):
    """A row-parallel projection's partial products ``y`` added over the
    model axis in float32 and rounded to ``dtype`` once."""
    return rules.mesh.all_reduce_sum(y.float(), AXIS).to(dtype)


# ---------------------------------------------------------------------------
# the recurrent blocks (``models/ssm.py``, ``models/rglru.py``)


def inner_split(width: int, rules) -> bool:
    """Whether a recurrent block of ``width`` channels (``"inner"``) runs
    channel parallel: the model axis splits them.  Otherwise the spec guard
    leaves the block's ``"inner"`` leaves whole and every rank computes the
    whole block, with no collective."""
    tp = tp_size(rules)
    return tp > 1 and width % tp == 0


def xz_channels(xz, rules):
    """The Mamba block's input projection on a rank: ``xz [B, S, 2·c]`` (c
    = din/tp), its product with the rank's block of ``in_proj``, which the
    reference stores as one contiguous block of the concatenated ``[x |
    z]`` columns (at tp = 4 ranks 0-1 hold columns of x, ranks 2-3 columns
    of z) -> (x, z), each ``[B, S, c]``, of the rank's channels ``[i·c,
    (i+1)·c)``: one ``exchange`` over the model axis.  Of the 2·tp blocks
    of c columns, rank i holds blocks 2i and 2i + 1 and block b belongs to
    the channels of rank b mod tp, so rank i receives block i (of x) from
    rank i // 2 and block tp + i (of z) from rank (tp + i) // 2."""
    tp, i = tp_size(rules), rules.mesh.coords[AXIS]
    dest = [(2 * i + j) % tp for j in (0, 1)]
    order = sorted((0, 1), key=dest.__getitem__)
    send, recv = [0] * tp, [0] * tp
    for j in (0, 1):
        send[dest[j]] += 1
    for src in (i // 2, (tp + i) // 2):
        recv[src] += 1
    blocks = xz.unflatten(-1, (2, -1)).movedim(-2, 0)    # [2, B, S, c]
    got = rules.mesh.exchange(blocks[order], AXIS, send, recv)
    return got[0], got[1]


# ---------------------------------------------------------------------------
# attention


class AttnLayout(NamedTuple):
    """How one rank holds an attention layer (module docstring)."""
    kv: str      # "heads" | "replicated" | "full" (not eligible) | "seq"
    tp: int      # model axis size
    idx: int     # this rank's model coordinate
    h0: int      # first q head of the rank
    h_loc: int   # q heads of the rank
    kv0: int     # first kv head its q heads read
    kv_loc: int  # kv heads they read


def seq_sharded(cfg, rules, rows=None, manual: bool = False) -> bool:
    """Whether the reference shards the queries of a step of ``rows = (B,
    S)`` on their sequence over the model axis: its manual block first
    (``rules["manual_tp"]`` with eligible heads, where ``manual``: its
    training forward; its prefills return keys and values and skip it),
    then ``AxisRules.spec(Q_AXES, q.shape)``.  ``rows`` None (a decode
    step, a cross-attention) never is."""
    if rows is None or tp_size(rules) <= 1:
        return False
    if manual and rules.rules.get("manual_tp") and attn_eligible(cfg, rules):
        return False
    spec = rules.spec(Q_AXES, (*rows, cfg.n_heads, cfg.head_dim_))
    return AXIS in spec_axes(spec[1:2])


def attn_layout(cfg, rules, rows=None, manual: bool = False) -> AttnLayout:
    """The layout of an attention layer on this rank: ``"seq"`` where
    :func:`seq_sharded` (``rows``, ``manual`` as there), else by the heads
    (module docstring)."""
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    tp = tp_size(rules)
    idx = rules.mesh.coords.get(AXIS, 0)
    if seq_sharded(cfg, rules, rows, manual):
        return AttnLayout("seq", tp, idx, 0, H, 0, Hkv)
    if not attn_eligible(cfg, rules):
        return AttnLayout("full", tp, idx, 0, H, 0, Hkv)
    h_loc = H // tp
    kv = "heads" if Hkv % tp == 0 else "replicated"
    return AttnLayout(kv, tp, idx, idx * h_loc, h_loc,
                      (idx * h_loc * Hkv) // H, max(1, h_loc * Hkv // H))


def attn_weights(p: dict, cfg, rules, lay: AttnLayout) -> dict:
    """The rank's attention weights as :func:`project` reads them: whole
    (gathered over the model axis) for ``"full"`` and ``"seq"``, else as
    given.  Under ``"seq"`` each whole weight sums its gradient over the
    model axis (every rank's covers its query rows only)."""
    if lay.kv not in ("full", "seq"):
        return p
    full = {"embed": cfg.d_model, "heads": cfg.n_heads,
            "kv_heads": cfg.n_kv_heads}
    axes = attn_lib.attention_axes("bq" in p)
    p = {k: gather_dims(t, axes[k], rules, full) for k, t in p.items()}
    if lay.kv == "seq":
        p = {k: _sum_grad_f32(t, rules.mesh) for k, t in p.items()}
    return p


def _sum_grad_f32(t, mesh):
    """``t``; under autograd its gradient summed over the model axis in
    float32 and rounded to ``t``'s dtype once."""
    if t.dtype == torch.float32 or not (t.requires_grad
                                        and torch.is_grad_enabled()):
        return mesh.sum_grad(t, AXIS)
    return mesh.sum_grad(t.float(), AXIS).to(t.dtype)


def _bias(p, name, x):
    return x + p[name].to(x.dtype) if name in p else x


def _rope(x, positions, theta):
    return L.apply_rope(x, positions, theta) if theta else x


def _q(p, x, positions, theta):
    return _rope(_bias(p, "bq", attn_lib._proj(x, p["wq"])), positions, theta)


def _kv(p, x, positions, theta):
    k, v = attn_lib._proj(x, p["wk"]), attn_lib._proj(x, p["wv"])
    return _rope(_bias(p, "bk", k), positions, theta), _bias(p, "bv", v)


def project(p, x, positions, theta, x_kv=None, lay=None, mesh=None):
    """x: [B,S,D] -> q [B,S,h_loc,hd] (the rank's heads), k and v (of
    ``x_kv``, default ``x``: encdec's cross-attention projects the
    encoder's memory) with the kv heads the layout holds: the rank's
    ``Hkv/tp`` (``"heads"``), else all ``Hkv``.  The bias follows the
    projection and RoPE of angle base ``theta`` (0: none) the bias, as
    ``attention.qkv_proj``.  Under autograd with ``lay`` and its ``mesh``,
    an input read only for the rank's heads sums its gradient over the
    model axis: ``x`` for q, and for k and v when the kv heads are sharded
    (whole kv projections get theirs complete through :func:`group`)."""
    own_kv = x_kv is not None
    x_kv = x_kv if own_kv else x
    if lay is not None and lay.kv != "full":
        x = mesh.sum_grad(x, AXIS)
        if lay.kv == "heads":
            x_kv = mesh.sum_grad(x_kv, AXIS) if own_kv else x
    return (_q(p, x, positions, theta), *_kv(p, x_kv, positions, theta))


def group(k, lay: AttnLayout, mesh=None):
    """The kv heads of ``k`` (as :func:`project` returns them) that the
    rank's q heads read.  Under autograd a slice of whole keys (the
    ``"replicated"`` layout, with its ``mesh``) sums the scattered
    gradient over the model axis: ranks whose q heads share a kv group
    each add their part, and every rank gets the whole keys' gradient."""
    if lay.kv == "heads":
        return k
    if lay.kv == "replicated" and mesh is not None:
        k = mesh.sum_grad(k, AXIS)
    return k[:, :, lay.kv0:lay.kv0 + lay.kv_loc]


def out_tp(p, o, rules, lay: AttnLayout, dtype):
    """The row-parallel output projection of the rank's heads' output
    ``o [B,S,h_loc,hd]``: its partial sums added over the model axis in
    float32 (whole, no sum, for ``"full"``)."""
    y = attn_lib.out_proj(p, o)
    if lay.kv == "full":
        return y
    return rules.mesh.all_reduce_sum(y.float(), AXIS).to(dtype)


def _into(buf, k, v, q_offset):
    """This call's keys and values into ``buf``'s slots from ``q_offset``
    on -> the buffer's first ``q_offset + S`` slots (no ``buf``: k, v)."""
    if buf is None:
        return k, v
    end = q_offset + k.shape[1]
    buf[0, :, q_offset:end] = k
    buf[1, :, q_offset:end] = v
    return buf[0, :, :end], buf[1, :, :end]


def manual_attention(lp, x, positions, cfg, rules, *, theta=None,
                     q_offset=0, causal=True, window=None, kv_len=None,
                     prefix_len=None, x_kv=None, buf=None, manual=False):
    """x: [B,S,D] (the normed input) -> (the attention output [B,S,D]
    (pre-residual), k, v): B6 on the rank's q heads against the kv heads
    they read, then the row-parallel output projection; under ``"seq"``
    (:func:`attn_layout` of the step's ``(B, S)``, ``manual`` as there;
    never with ``x_kv``) B6 on the rank's query rows with every head, then
    the gather of the output's rows.  ``k`` and ``v`` are this call's keys
    and values as :func:`project` holds them (of ``x_kv``, default ``x``;
    every kv head under ``"seq"``), for a cache.  ``buf`` ``[2, B, N, hk,
    hd]`` holds the keys and values of the positions before ``q_offset`` (a
    chunked prefill): this call's go into its slots from ``q_offset`` on
    and the queries attend to its first ``q_offset + S``.  RoPE at
    ``positions`` with ``theta`` (default ``cfg.rope_theta``; 0: none);
    the rest as ``attention.attend``."""
    rows = None if x_kv is not None else tuple(x.shape[:2])
    lay = attn_layout(cfg, rules, rows, manual)
    p = attn_weights(lp, cfg, rules, lay)
    theta = cfg.rope_theta if theta is None else theta
    masks = dict(causal=causal, window=window, kv_len=kv_len,
                 prefix_len=prefix_len)
    if lay.kv == "seq":
        return _seq_attention(p, x, positions, theta, rules, lay, q_offset,
                              buf, masks)
    q, k, v = project(p, x, positions, theta, x_kv, lay, rules.mesh)
    ka, va = _into(buf, k, v, q_offset)
    o = attn_lib.attend(q, group(ka, lay, rules.mesh),
                        group(va, lay, rules.mesh), q_offset, **masks)
    return out_tp(p, o, rules, lay, x.dtype), k, v


def _seq_attention(p, x, positions, theta, rules, lay: AttnLayout, q_offset,
                   buf, masks):
    """:func:`manual_attention` under ``"seq"`` (module docstring): the
    rank's rows ``[r0, r0 + S/tp)`` of the queries, every head, against
    the keys and values of the whole input; the rows of the output
    all-gathered over the model axis."""
    mesh = rules.mesh
    x = mesh.sum_grad(x, AXIS)
    s = x.shape[1] // lay.tp
    r0 = lay.idx * s
    q = _q(p, x[:, r0:r0 + s],
           None if positions is None else positions[..., r0:r0 + s], theta)
    k, v = _kv(p, x, positions, theta)
    ka, va = _into(buf, k, v, q_offset)
    o = attn_lib.attend(q, ka, va, q_offset + r0, **masks)
    y = attn_lib.out_proj(p, o)
    return torch.cat(list(mesh.all_gather(y, AXIS)), dim=1), k, v


def seq_shard(k, rules, lay: AttnLayout, filled: int):
    """A cache layer ``k [B, C, hk, hd]`` (the kv heads :func:`project`
    holds, every slot; slots from ``filled`` on are zero) -> this rank's
    sequence shard with every kv head, ``[B, C/n, Hkv, hd]`` for ``n`` the
    model axis: one ``all_to_all`` of each shard's first ``filled`` slots
    when the kv heads are sharded, else a slice."""
    n = tp_size(rules)
    s_loc = k.shape[1] // n
    i = rules.mesh.coords.get(AXIS, 0)
    if lay.kv != "heads":
        return k[:, i * s_loc:(i + 1) * s_loc]
    f = min(s_loc, filled)
    x = k.unflatten(1, (n, s_loc))[:, :, :f].movedim(1, 0)  # [n, B, f, ..]
    x = rules.mesh.all_to_all(x, AXIS)                 # [n] from each rank
    out = k.new_zeros((k.shape[0], s_loc, n * k.shape[2], k.shape[3]))
    out[:, :f] = x.movedim(0, 2).flatten(2, 3)         # [B, f, n·hk, hd]
    return out


def _whole(piece, part):
    """An all-gathered ``[tp, B, 1, a·b]`` piece of ``part [B, 1, a, b]``
    (split over heads) -> ``[B, 1, tp·a, b]``."""
    return piece.unflatten(-1, part.shape[2:]).movedim(0, 2).flatten(2, 3)


def all_heads(k, rules, lay: AttnLayout):
    """``k [B, S, hk, hd]`` as :func:`project` holds it -> every kv head
    on every rank (an all-gather over the model axis when the kv heads
    are sharded)."""
    if lay.kv != "heads":
        return k
    return torch.cat(list(rules.mesh.all_gather(k, AXIS)), dim=2)


def decode_qkv(p, h, length, cfg, rules, lay: AttnLayout, theta):
    """h: [B,1,D] -> q [B,1,H,hd], k, v [B,1,Hkv,hd], whole on every rank
    of the model axis: the rank's part of each (its q heads; its kv heads
    when they are sharded) in one all-gather.  RoPE at ``length`` with
    ``theta`` (0: none)."""
    q, k, v = project(p, h, length[:, None], theta)
    if lay.kv == "full":
        return q, k, v
    parts = [q] if lay.kv == "replicated" else [q, k, v]
    flat = torch.cat([t.flatten(2) for t in parts], dim=-1)
    got = rules.mesh.all_gather(flat, AXIS).split(
        [t.shape[2] * t.shape[3] for t in parts], dim=-1)
    whole = [_whole(g, t) for g, t in zip(got, parts)]
    return tuple(whole) if lay.kv == "heads" else (whole[0], k, v)


def decode_attention(lp, h, k_cache, v_cache, length, cfg, rules,
                     theta=None):
    """One decode step of an attention layer on a sequence-sharded cache:
    h [B,1,D] (normed); k_cache, v_cache this rank's ``[B, S/n, Hkv,
    hd]`` (updated in place: slot ``length`` on its owner).  Returns the
    attention output [B,1,D] (pre-residual).  ``theta`` as for
    :func:`manual_attention`."""
    lay = attn_layout(cfg, rules)
    p = attn_weights(lp, cfg, rules, lay)
    theta = cfg.rope_theta if theta is None else theta
    q, k, v = decode_qkv(p, h, length, cfg, rules, lay, theta)
    attn_lib.cache_update_sharded(k_cache, v_cache, k, v, length, rules.mesh)
    o = attn_lib.decode_attend_partitioned(q[:, 0], k_cache, v_cache,
                                           length + 1, rules.mesh)
    return out_tp(p, o[:, None, lay.h0:lay.h0 + lay.h_loc], rules, lay,
                  h.dtype)


def decode_attention_ring(lp, h, k_cache, v_cache, length, cfg, rules,
                          window):
    """One decode step of the hybrid's attention layer, whose ring cache of
    ``window`` slots every rank of the model axis holds whole (``"null"``
    on its sequence and heads, split over the batch only): q for the
    rank's heads and k, v as :func:`project` gives them (every kv head on
    every rank: :func:`all_heads`), the new keys and values written into
    slot ``length % window`` of every rank's ring at RoPE position
    ``length`` (the reference's slot and position, ROADMAP C4), the rank's
    q heads attending the ring's first ``min(length + 1, window)`` slots
    of the kv heads they read, then the row-parallel output projection.
    h: [B,1,D] (normed); returns the attention output [B,1,D]
    (pre-residual)."""
    lay = attn_layout(cfg, rules)
    p = attn_weights(lp, cfg, rules, lay)
    q, k, v = project(p, h, length[:, None], cfg.rope_theta)
    k, v = all_heads(k, rules, lay), all_heads(v, rules, lay)
    attn_lib.cache_update_local(k_cache, v_cache, k, v, length % window)
    heads = slice(lay.kv0, lay.kv0 + lay.kv_loc)
    o = attn_lib.decode_attend_local(
        q[:, 0], k_cache[:, :, heads], v_cache[:, :, heads],
        torch.arange(window, device=h.device),
        torch.clamp(length + 1, max=window))
    return out_tp(p, o[:, None], rules, lay, h.dtype)
