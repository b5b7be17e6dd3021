"""Decoder-only LM assembly: the training forward, prefill and decode of
the dense, moe, ssm, hybrid and vlm families.

The port of the JAX package's ``repro.models.transformer`` on one device.
Parameters are nested dictionaries with the JAX package's tree and layouts:
``params["stack"]`` holds every layer's leaves stacked on a leading ``[L]``
axis (dense, moe, ssm); the hybrid family (recurrentgemma's 1:2
RG-LRU:attention pattern) holds ``params["groups"]`` of (``rec1``,
``rec2``, ``attn``) layers stacked on ``[n_layers // 3]`` and
``params["tail"]``, the ``n_layers % 3`` recurrent layers after them.
The layer loops (``lax.scan`` and ``fori_loop`` there) are Python loops.
A moe layer is an attention layer whose MLP is ``models/moe.apply_moe``;
its router and expert weights are stored in ``cdtype`` like any block
matmul weight.  A vlm is a dense decoder whose prefill puts the image
embeddings (``prefix_embeds``, from the stub frontend) before the tokens'
and attends with the prefix-LM mask (``prefix_len``: the image positions
see each other both ways); its decode is the dense decode.  The encdec
family is ``models/encdec.py``.

On a mesh (``rules``, ``models/sharding.py``) every family runs each
rank's shards of the parameters: ``forward``, ``prefill`` and
``decode_step`` take ``rules`` (and ``decode_step`` the ``mesh``), their
layers go through ``models/manual_tp.py`` (tensor parallel over
``"model"``, the FSDP split of ``"embed"`` and ``"expert_embed"`` gathered
layer by layer; a moe layer's experts expert parallel over ``"model"``,
``models/moe.py``; the ssm and RG-LRU blocks channel parallel over
``"model"``, ``models/ssm.py`` and ``models/rglru.py``), and the batch is
split over ``"data"`` when it divides.  An attention layer whose queries
the reference shards on their sequence (its ``"seq"`` policy: heads that
do not divide the model axis, a step length that does) runs each rank's
block of query rows with every head and gathers the output's rows
(``manual_tp``'s ``"seq"`` layout), in the whole and the chunked prefill
and in ``forward``.  The dense, moe and vlm KV cache
is sharded over ``"model"`` on its sequence axis; the hybrid's ring cache
stays whole on every rank of ``"model"`` (the reference's ``"null"``),
and its recurrent states and the ssm's hold the rank's channels.  A call
takes the whole batch (the same on every rank) and returns the rank's
rows.

``forward`` (training) runs every layer once over the whole sequence,
as prefill's whole branch does, and sums the moe layers' aux losses;
under ``remat`` each layer is recomputed in the backward.  On a mesh its
carry between layers is each rank's block of sequence rows where the
reference's ``"act_seq"`` boundary splits it (:func:`carry_axis`).  It
reads the stacked leaves through ``unstack`` (one ``unbind`` a leaf).

Serving weights are stored as the reference uses them
(``storage_dtype``): block matmul weights and biases in ``cfg.cdtype`` —
bit-identical to the reference's ``cast_layer_params`` casting the
float32 master copy at every use — the embedding table in ``cdtype`` (``embed`` casts before the
gather), and the unembed and every norm in ``cfg.pdtype``: the reference's
decode reads the norms uncast, its prefill through ``cast_layer_params``.
So do the ssm block's ``x_proj`` and ``dt_proj``, which the reference's
decode reads in float32 and its prefill rounded to ``cdtype``.  The
recurrences' numerics-sensitive leaves (``_KEEP_F32``) stay float32
everywhere, as in the reference.  Training stores every leaf in the
reference's float32 (``storage_dtype(train=True)``).

The KV cache and the recurrent states are updated in place (the reference
rebuilds them functionally); ``decode_step`` consumes the state it is
given.  The hybrid's attention layers keep a ring cache of
``min(max_len, window)`` slots, keyed by absolute position mod window after
prefill; its decode copies the reference's slot and RoPE position, which
after a prompt longer than the window are ``length % window`` and
``length`` with ``length`` clamped to the window (ROADMAP C4).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import manual_tp as tp_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.attention import KVCache
from repro_torch.models.sharding import batch_rows, gather_dims

#: the families this module assembles (encdec is ``models/encdec.py``)
_PORTED = ("dense", "moe", "ssm", "hybrid", "vlm")


def check_family(cfg: ArchConfig) -> None:
    if cfg.family not in _PORTED:
        raise ValueError(f"{cfg.name}: family {cfg.family!r} is not one of "
                         f"the decoder-only families {_PORTED}")


class DecodeState(NamedTuple):
    kv: Optional[KVCache]                     # [n_attn_layers, ...]
    ssm: Optional[ssm_lib.SSMState] = None    # [n_ssm_layers, ...]
    lru: Optional[rglru_lib.LRUState] = None  # [n_rec_layers, ...]


def layer_plan(cfg: ArchConfig) -> list:
    check_family(cfg)
    if cfg.family == "moe":
        return ["moe"] * cfg.n_layers
    if cfg.family == "ssm":
        return ["ssm"] * cfg.n_layers
    if cfg.family == "hybrid":
        pat = cfg.hybrid.pattern  # ("recurrent", "recurrent", "attention")
        kinds = {"recurrent": "rec", "attention": "attn"}
        return [kinds[pat[i % len(pat)]] for i in range(cfg.n_layers)]
    return ["attn"] * cfg.n_layers


def _window(cfg: ArchConfig) -> Optional[int]:
    return cfg.hybrid.window if cfg.family == "hybrid" else None


def check_cache_covers_window(cfg: ArchConfig, slots: int) -> None:
    """The hybrid's decode reads ``window`` ring slots: a cache of fewer
    (``max_len < window``) cannot be decoded.  The reference fails there
    with a broadcasting error (ROADMAP C5); the port raises this."""
    window = _window(cfg)
    if window and slots < window:
        raise ValueError(
            f"{cfg.name}: a decode cache of {slots} slots (max_len {slots}) "
            f"is shorter than the attention window {window}; the hybrid's "
            f"decode needs max_len >= window")


# ---------------------------------------------------------------------------
# params

#: norm leaves, stored in ``pdtype`` (``ln_x`` is encdec's cross-attention
#: norm, ``enc_norm`` its encoder's final norm)
_NORMS = ("ln1", "ln2", "ln_x")
_TOP_NORMS = ("final_norm", "enc_norm")
#: numerics-sensitive leaves that stay float32 through the recurrences (the
#: reference's ``_KEEP_F32``: never cast to the compute dtype)
_KEEP_F32 = {"A_log", "D", "lam", "w_a", "b_a", "w_x", "b_x", "dt_bias"}
#: leaves the reference's decode reads in float32 and its prefill cast to
#: the compute dtype: stored in ``pdtype`` and cast at prefill, like a norm
_DECODE_F32 = {"x_proj", "dt_proj"}


def storage_dtype(path: tuple, cfg: ArchConfig,
                  train: bool = False) -> torch.dtype:
    """The dtype a parameter leaf is stored in (see the module docstring):
    ``path`` is its key path, e.g. ``("stack", "attn", "wq")``, ``("stack",
    "moe", "wi")``, ``("groups", "rec1", "rec", "lam")`` or encdec's
    ``("decoder", "ln_x", "scale")``.  With ``train``, the reference's own
    dtypes instead, the ones it trains: every leaf in ``cfg.pdtype``
    (float32), the ``_KEEP_F32`` leaves in float32."""
    if train:
        return torch.float32 if path[-1] in _KEEP_F32 else cfg.pdtype
    if path[0] == "embed":
        if path[-1] == "embedding" and not cfg.tie_embeddings:
            return cfg.cdtype
        return cfg.pdtype
    if path[0] in _TOP_NORMS or path[-2] in _NORMS:
        return cfg.pdtype
    if path[-1] in _KEEP_F32:
        return torch.float32
    if path[-1] in _DECODE_F32:
        return cfg.pdtype
    return cfg.cdtype


def init_layer(gen: torch.Generator, cfg: ArchConfig, kind: str, device):
    """One layer's parameters of ``kind`` (``attn``, ``moe``, ``rec`` or
    ``ssm``) in ``cfg.pdtype``, as the reference draws them."""
    d, dt = cfg.d_model, cfg.pdtype
    p = {"ln1": L.init_norm(dt, d, cfg.norm, device)}
    if kind in ("attn", "moe"):
        p["attn"] = attn.init_attention(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                        cfg.head_dim_, dt, cfg.qkv_bias,
                                        device)
    elif kind == "rec":
        p["rec"] = rglru_lib.init_rglru(gen, cfg, dt, device)
    elif kind == "ssm":
        p["ssm"] = ssm_lib.init_ssm(gen, cfg, dt, device)
        return p                          # the mamba block has no MLP
    else:
        raise ValueError(f"unknown layer kind {kind!r}")
    p["ln2"] = L.init_norm(dt, d, cfg.norm, device)
    if kind == "moe":
        p["moe"] = moe_lib.init_moe(gen, d, cfg.moe, dt, cfg.gated_mlp,
                                    cfg.act, device)
    else:
        p["mlp"] = L.init_mlp(gen, d, cfg.d_ff, dt, cfg.gated_mlp, device)
    return p


def stacked_init(make_layer, cfg, n, device, prefix=("stack",),
                 train=False):
    """``n`` layers of ``make_layer()`` stacked on a leading axis in their
    storage dtypes (``prefix`` is the stack's key path; ``train`` as for
    :func:`storage_dtype`), drawn one layer at a time so that only one
    layer's float32 draws are live besides the stack."""
    stack = None
    for i in range(n):
        lp = make_layer()
        if stack is None:
            stack = {g: {k: torch.empty(
                (n,) + t.shape, device=device,
                dtype=storage_dtype(prefix + (g, k), cfg, train))
                for k, t in leaves.items()} for g, leaves in lp.items()}
        for g, leaves in lp.items():
            for k, t in leaves.items():
                stack[g][k][i].copy_(t)
    return stack


def init_params(gen: torch.Generator, cfg: ArchConfig, device,
                train: bool = False) -> dict:
    """Random parameters with the JAX package's scales and layouts, drawn
    from ``gen`` on ``device`` (different numbers from the reference's),
    each leaf in its storage dtype (``train``: the reference's dtypes,
    see :func:`storage_dtype`)."""
    plan = layer_plan(cfg)
    emb = L.init_embedding(gen, L.pad_vocab(cfg.vocab), cfg.d_model,
                           cfg.pdtype, cfg.tie_embeddings, device)
    params = {"embed": {k: t.to(storage_dtype(("embed", k), cfg, train))
                        for k, t in emb.items()}}
    if cfg.family == "hybrid":
        ng = cfg.n_layers // 3
        params["groups"] = {
            name: stacked_init(lambda kind=kind: init_layer(
                gen, cfg, kind, device), cfg, ng, device, ("groups", name),
                train)
            for name, kind in (("rec1", "rec"), ("rec2", "rec"),
                               ("attn", "attn"))}
        if cfg.n_layers % 3:
            params["tail"] = stacked_init(
                lambda: init_layer(gen, cfg, "rec", device), cfg,
                cfg.n_layers % 3, device, ("tail",), train)
    else:
        params["stack"] = stacked_init(
            lambda: init_layer(gen, cfg, plan[0], device), cfg, cfg.n_layers,
            device, train=train)
    params["final_norm"] = L.init_norm(cfg.pdtype, cfg.d_model, cfg.norm,
                                       device)
    return params


def layer_axes(cfg: ArchConfig, kind: str) -> dict:
    """The reference's logical axes of one layer's leaves (no ``"layers"``
    axis), as :func:`init_layer` draws them."""
    a = {"ln1": L.norm_axes(cfg.norm)}
    if kind in ("attn", "moe"):
        a["attn"] = attn.attention_axes(cfg.qkv_bias)
    elif kind == "rec":
        a["rec"] = dict(rglru_lib.RGLRU_AXES)
    elif kind == "ssm":
        a["ssm"] = dict(ssm_lib.SSM_AXES)
        return a
    a["ln2"] = L.norm_axes(cfg.norm)
    if kind == "moe":
        a["moe"] = moe_lib.moe_axes(cfg.gated_mlp)
    else:
        a["mlp"] = L.mlp_axes(cfg.gated_mlp)
    return a


def param_axes(cfg: ArchConfig) -> dict:
    """The reference's logical axes tree of :func:`init_params`' params,
    leaf for leaf (stacked leaves lead with ``"layers"``)."""
    plan = layer_plan(cfg)
    a = {"embed": L.embedding_axes(cfg.tie_embeddings)}
    if cfg.family == "hybrid":
        a["groups"] = L.add_layer_axis(
            {"rec1": layer_axes(cfg, "rec"), "rec2": layer_axes(cfg, "rec"),
             "attn": layer_axes(cfg, "attn")})
        if cfg.n_layers % 3:
            a["tail"] = L.add_layer_axis(layer_axes(cfg, "rec"))
    else:
        a["stack"] = L.add_layer_axis(layer_axes(cfg, plan[0]))
    a["final_norm"] = L.norm_axes(cfg.norm)
    return a


def gather_fsdp(lp: dict, axes: dict, cfg: ArchConfig, rules) -> dict:
    """A layer's (or any subtree's) leaves with their FSDP split of
    ``"embed"`` and ``"expert_embed"`` gathered (``axes`` without the
    ``"layers"`` axis); the tensor-parallel and expert-parallel splits
    stay."""
    if rules is None:
        return lp
    if isinstance(lp, dict):
        return {k: gather_fsdp(v, axes[k], cfg, rules) for k, v in lp.items()}
    return gather_dims(lp, axes, rules, {"embed": cfg.d_model,
                                         "expert_embed": cfg.d_model})


def _layer(stack: dict, i: int) -> dict:
    """Layer ``i``'s leaves (views into the stacked tensors)."""
    return {g: {k: t[i] for k, t in leaves.items()}
            for g, leaves in stack.items()}


def unstack(tree) -> list:
    """Every layer's leaves of a stacked tree (views), one ``unbind`` per
    leaf.  Under autograd that is one backward node per leaf, which stacks
    the layers' gradients once; ``t[i]`` per layer would allocate a whole
    ``[L, ...]`` gradient for each layer.  A leaf may also be a list of
    per-layer tensors already (``train_step``'s per-layer leaves)."""
    if isinstance(tree, dict):
        parts = {k: unstack(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: parts[k][i] for k in parts} for i in range(n)]
    return list(tree.unbind(0) if isinstance(tree, torch.Tensor) else tree)


def cast_layer_params(lp: dict, cdtype: torch.dtype) -> dict:
    """Cast a layer's float32 leaves to the compute dtype, as the reference
    does at every full-sequence use, except the ``_KEEP_F32`` leaves: here
    the norms, ``x_proj`` and ``dt_proj`` are the float32 leaves that cast
    (the matmul weights are stored in ``cdtype`` already)."""
    return {g: {k: (t.to(cdtype) if t.dtype == torch.float32
                    and k not in _KEEP_F32 else t)
                for k, t in leaves.items()}
            for g, leaves in lp.items()}


def _state_at(state, i):
    """Layer ``i``'s slice of a stacked recurrent state (views)."""
    return type(state)(*(t[i] for t in state))


def _put_state(state, i, new) -> None:
    """Write one layer's new recurrent state into slot ``i`` of the stack."""
    for dst, src in zip(state, new):
        dst[i].copy_(src)


# ---------------------------------------------------------------------------
# layer application (full sequence: prefill)


def _apply_attn_layer(lp, cfg, x, positions, window=None, prefix_len=None):
    """Returns (x, (k, v)): the layer's keys and values fill the cache."""
    h = L.apply_norm(lp["ln1"], x, cfg.norm)
    q, k, v = attn.qkv_proj(lp["attn"], h, positions, cfg.rope_theta)
    o = attn.attend(q, k, v, 0, causal=True, window=window,
                    prefix_len=prefix_len)
    return x + attn.out_proj(lp["attn"], o), (k, v)


def _mlp_aux(lp, cfg, x, rules=None, aux=True):
    """The MLP half of a layer: the dense MLP (tensor parallel with
    ``rules``), or the moe layer's experts (expert parallel with
    ``rules``).  Returns (x, the moe aux loss or None; with ``rules`` and
    without ``aux``, None)."""
    h = L.apply_norm(lp["ln2"], x, cfg.norm)
    if "moe" in lp:
        kw = {} if rules is None else {"rules": rules, "aux": aux}
        y, a = moe_lib.apply_moe(lp["moe"], h, cfg.moe, cfg.act, **kw)
        return x + y, a
    if rules is not None:
        return x + tp_lib.manual_mlp(lp["mlp"], h, cfg, rules), None
    return x + L.apply_mlp(lp["mlp"], h, cfg.act), None


def _apply_mlp(lp, cfg, x, rules=None):
    """:func:`_mlp_aux` for serving, which never reads the aux loss."""
    return _mlp_aux(lp, cfg, x, rules, aux=False)[0]


def _apply_layer_full(lp, cfg, kind, x, positions, prefix_len=None,
                      rules=None, manual=False):
    """One layer of ``kind``, full sequence (``attn`` and ``moe`` differ
    only in their MLP; ``prefix_len`` is the vlm's image prefix).  Returns
    (x, (k, v) or None, new recurrent state or None, moe aux or None).
    With ``rules`` the layer runs on the rank's blocks (its FSDP split
    gathered first): an attention layer tensor parallel or on the rank's
    query rows (``manual_tp.manual_attention``; ``manual``: the training
    forward, where the reference's manual block comes first), its keys and
    values as ``manual_tp.project`` holds them; a recurrent one channel
    parallel, its state the rank's channels."""
    if rules is not None:
        lp = gather_fsdp(lp, layer_axes(cfg, kind), cfg, rules)
    lp = cast_layer_params(lp, cfg.cdtype)
    if kind == "ssm":
        h = L.apply_norm(lp["ln1"], x, cfg.norm)
        y, st = ssm_lib.apply_ssm(lp["ssm"], h, cfg, rules=rules)
        return x + y, None, st, None
    if kind == "rec":
        h = L.apply_norm(lp["ln1"], x, cfg.norm)
        y, st = rglru_lib.apply_rglru(lp["rec"], h, cfg=cfg, rules=rules)
        x, aux = _mlp_aux(lp, cfg, x + y, rules)
        return x, None, st, aux
    if rules is not None:
        h = L.apply_norm(lp["ln1"], x, cfg.norm)
        y, k, v = tp_lib.manual_attention(lp["attn"], h, positions, cfg,
                                          rules, window=_window(cfg),
                                          prefix_len=prefix_len,
                                          manual=manual)
        x, kv = x + y, (k, v)
    else:
        x, kv = _apply_attn_layer(lp, cfg, x, positions, window=_window(cfg),
                                  prefix_len=prefix_len)
    x, aux = _mlp_aux(lp, cfg, x, rules)
    return x, kv, None, aux


# ---------------------------------------------------------------------------
# forward (train)


def checkpointed(fn, remat: bool):
    """``fn`` recomputed in the backward (``torch.utils.checkpoint``,
    non-reentrant: only its inputs are saved) when ``remat``."""
    if not remat:
        return fn
    return lambda *args: torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False)


#: while a list (``launch/distributed.LayoutLog`` sets it), the training
#: forward appends one ``(layout, shape)`` pair per layer call (the
#: hybrid's: per group and tail layer), in call order: ``"rows"`` or
#: ``"whole"`` (:func:`carry_axis`) and the shape of the carry that call
#: (its checkpoint) received, the embedding's output for the first
CARRY_LOG: Optional[list] = None


def carry_axis(rules, shape) -> Optional[str]:
    """The mesh axis the training forward splits its layer-boundary carry
    over, on the sequence: the reference's ``("batch", "act_seq", None)``
    constraint (Megatron-SP) of the carry's global ``shape`` ``[B, S, D]``
    where that axis has more than one rank; None (the carry stays whole)
    without ``rules``, where the rules map ``"act_seq"`` to nothing or the
    axis does not divide S."""
    if rules is None:
        return None
    spec = rules.spec(("batch", "act_seq", None), tuple(shape))
    axis = spec[1] if len(spec) > 1 else None
    return axis if axis is not None and rules.mesh.shape[axis] > 1 else None


def _gather_rows(x, mesh, axis):
    """Every rank's sequence rows ``x [B, s, D]`` over ``axis``, joined in
    coordinate order: ``[B, n·s, D]`` (a view of the gather at B = 1)."""
    parts = mesh.all_gather(x, axis)
    return parts.movedim(0, 1).reshape(x.shape[0], -1, x.shape[2])


def forward(params, cfg: ArchConfig, tokens, *, prefix_embeds=None,
            prefix_len=None, remat=True, rules=None):
    """The training forward.  tokens: [B,S] int; prefix_embeds: [B,P,D] or
    None (the vlm's image embeddings before the tokens', ``prefix_len``
    of them attended both ways).  Returns (logits [B, P+S, V] float32, the
    moe layers' aux losses summed, a float32 scalar).

    The layers run one at a time (the hybrid one (rec1, rec2, attn) group
    at a time), each recomputed in the backward under ``remat``: the
    reference's ``jax.checkpoint`` of its scan body.  The attention layers
    go through ``attend``, which on the card launches the flash kernel in
    the forward and again in the recompute.  With ``rules`` (a rank's
    params) each layer runs tensor parallel (the reference's manual arm)
    on the rank's rows of the batch, and the logits are those rows'; the
    aux losses are the global batch's (``moe.apply_moe``), the same on
    every rank.

    Where :func:`carry_axis` names an axis (the reference's ``"act_seq"``
    boundary), the carry between layers is the rank's block of S / n
    sequence rows over it: the embedding's output is cut to it
    (``Mesh.take_block``), each layer gathers the rows at its input
    (``Mesh.all_gather(grad="slice")``) and cuts its output, and the last
    layer's rows are gathered once more for the logits.  Every block sums
    its input's gradient over ``"model"``, so that gradient is whole and
    the same on every rank, and the pair computes the bits of the whole
    carry; only what the checkpoints keep shrinks, by n.  The gather runs
    inside the checkpointed function and again in its recompute."""
    check_family(cfg)
    whole_batch = tokens.shape[0]
    if rules is not None:
        tokens, prefix_embeds = _rows(tokens, prefix_embeds, rules)
    x = _embed_with_prefix(params, cfg, tokens, prefix_embeds, rules)
    positions = torch.arange(x.shape[1], device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    axis = carry_axis(rules, (whole_batch,) + tuple(x.shape[1:]))
    mesh = rules.mesh if axis is not None else None

    def carried(fn):
        """``fn(x, lp) -> (x, aux)`` on the whole carry, run on the
        carry's layout and recomputed under ``remat``."""
        if axis is None:
            return checkpointed(fn, remat)

        def f(x, lp):
            x, a = fn(_gather_rows(x, mesh, axis), lp)
            return mesh.take_block(x, axis, 1), a
        return checkpointed(f, remat)

    def call(f, x, lp):
        if CARRY_LOG is not None:
            CARRY_LOG.append(("whole" if axis is None else "rows",
                              tuple(x.shape)))
        return f(x, lp)

    def layer(kind):
        def f(x, lp):
            x, _, _, a = _apply_layer_full(lp, cfg, kind, x, positions,
                                           prefix_len, rules, manual=True)
            return x, a
        return carried(f)

    if axis is not None:
        x = mesh.take_block(x, axis, 1)
    if cfg.family == "hybrid":
        def group(x, gp):
            for name, kind in (("rec1", "rec"), ("rec2", "rec"),
                               ("attn", "attn")):
                x, _, _, _ = _apply_layer_full(gp[name], cfg, kind, x,
                                               positions, rules=rules,
                                               manual=True)
            return x, None
        group = carried(group)
        for gp in unstack(params["groups"]):
            x, _ = call(group, x, gp)
        for lp in unstack(params["tail"]) if "tail" in params else ():
            x, _ = call(layer("rec"), x, lp)
    else:
        f = layer(layer_plan(cfg)[0])
        for lp in unstack(params["stack"]):
            x, a = call(f, x, lp)
            if a is not None:
                aux = aux + a
    if axis is not None:
        x = _gather_rows(x, mesh, axis)
    return final_logits(params, cfg, x, rules), aux


# ---------------------------------------------------------------------------
# prefill: forward + build decode state

PREFILL_CHUNK = 4096
#: families whose long prompts take the chunked prefill (the reference's;
#: the recurrent families always take the whole one)
CHUNKED_FAMILIES = ("dense", "moe", "vlm")


def prefill(params, cfg: ArchConfig, tokens, *, max_len=None,
            prefix_embeds=None, prefix_len=None,
            chunk: int = PREFILL_CHUNK, rules=None):
    """tokens: [B,S] int; prefix_embeds: [B,P,D] or None (the vlm's image
    embeddings, put before the tokens' in ``cdtype``; ``prefix_len``
    positions attend bidirectionally).  Returns (last_logits [B,V] f32,
    DecodeState).

    A dense, moe or vlm sequence (prefix included) longer than ``chunk``
    whose length is a multiple of it is processed in chunks
    (``_prefill_chunked``); any other, and every ssm and hybrid prompt, in
    one pass (``_prefill_whole``), as in the reference.  A moe layer's
    expert capacity follows each call's own length: a chunk's, not the
    prompt's.  With ``rules``: :func:`_prefill_sharded` for the dense,
    moe and vlm families, the whole prefill on the rank's blocks for the
    recurrent ones."""
    check_family(cfg)
    S_tot = tokens.shape[1] + (prefix_embeds.shape[1]
                               if prefix_embeds is not None else 0)
    kw = dict(prefix_embeds=prefix_embeds, prefix_len=prefix_len)
    chunked = (cfg.family in CHUNKED_FAMILIES and S_tot > chunk
               and S_tot % chunk == 0 and (max_len or S_tot) >= S_tot)
    if rules is not None and cfg.family in CHUNKED_FAMILIES:
        return _prefill_sharded(params, cfg, tokens, max_len=max_len or S_tot,
                                step=chunk if chunked else S_tot,
                                rules=rules, **kw)
    if chunked:
        return _prefill_chunked(params, cfg, tokens, max_len=max_len or S_tot,
                                chunk=chunk, **kw)
    return _prefill_whole(params, cfg, tokens, max_len=max_len, rules=rules,
                          **kw)


def final_logits(params, cfg, x_last, rules=None):
    """The final norm and the unembed of ``x_last [B, D]``, in float32
    (with ``rules``: from the rank's shards, the whole vocab gathered)."""
    norm = gather_fsdp(params["final_norm"], L.norm_axes(cfg.norm), cfg,
                       rules)
    x = L.apply_norm(norm, x_last, cfg.norm)
    return L.unembed(params["embed"], x.float(), cfg.vocab, rules)


def _rows(tokens, extra, rules):
    """The rank's rows of a whole batch's tokens and extra input."""
    rows = batch_rows(tokens.shape[0], rules)
    return tokens[rows], None if extra is None else extra[rows]


def _embed_with_prefix(params, cfg, tokens, prefix_embeds, rules=None):
    """The tokens' embeddings, after the prefix's (cast to ``cdtype``)."""
    x = L.embed(params["embed"], tokens, cfg.cdtype, rules, cfg.vocab)
    if prefix_embeds is None:
        return x
    return torch.cat([prefix_embeds.to(cfg.cdtype), x], dim=1)


def _prefill_chunked(params, cfg: ArchConfig, tokens, *, max_len, chunk,
                     prefix_embeds=None, prefix_len=None):
    """Each chunk attends against the cache filled so far plus itself
    (``attend`` with ``q_offset = off`` on a prefix view of the cache),
    writing its keys and values into the cache in place."""
    x_all = _embed_with_prefix(params, cfg, tokens, prefix_embeds)
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
                            off, causal=True, prefix_len=prefix_len)
            x = _apply_mlp(lp, cfg, x + attn.out_proj(lp["attn"], o))
        last_x = x
    last = final_logits(params, cfg, last_x[:, -1])
    length = torch.full((B,), S_tot, dtype=torch.int32, device=x_all.device)
    return last, DecodeState(kv=KVCache(k=kc, v=vc, length=length))


def check_seq_shards(max_len: int, rules) -> None:
    """A cache sharded over the model axis on its sequence needs a length
    the axis divides."""
    n = tp_lib.tp_size(rules)
    if max_len % n:
        raise ValueError(f"a KV cache of {max_len} slots does not split "
                         f"over a model axis of {n}; pick max_len a "
                         f"multiple of it")


def _prefill_sharded(params, cfg: ArchConfig, tokens, *, max_len, step,
                     rules, prefix_embeds=None, prefix_len=None):
    """The prefill on a mesh: the rank's rows of the batch, ``step``
    positions at a time (a chunk, or the whole prompt in one), every layer
    tensor parallel (``manual_tp``): B6 on the rank's q heads against the
    kv heads they read (under ``"seq"``, chosen per step: on the rank's
    rows of the step with every head against every kv head), whose keys
    and values (every position so far) it keeps in a buffer of ``max(S,
    max_len)`` slots.  Then each layer's
    buffer becomes the rank's sequence shard of the cache with every kv
    head (``manual_tp.seq_shard``), holding the last ``max_len`` positions
    as the unsharded prefill does."""
    check_seq_shards(max_len, rules)
    tokens, prefix_embeds = _rows(tokens, prefix_embeds, rules)
    x_all = _embed_with_prefix(params, cfg, tokens, prefix_embeds, rules)
    B, S_tot, _ = x_all.shape
    dev = x_all.device
    lay = tp_lib.attn_layout(cfg, rules, (B, step))
    hk = cfg.n_kv_heads // lay.tp if lay.kv == "heads" else cfg.n_kv_heads
    n_buf = max(S_tot, max_len)
    kbuf = torch.zeros((2, cfg.n_layers, B, n_buf, hk, cfg.head_dim_),
                       dtype=cfg.cdtype, device=dev)
    axes = layer_axes(cfg, layer_plan(cfg)[0])
    for off in range(0, S_tot, step):
        x = x_all[:, off:off + step]
        q_pos = off + torch.arange(step, device=dev)
        for i in range(cfg.n_layers):
            lp = cast_layer_params(gather_fsdp(_layer(params["stack"], i),
                                               axes, cfg, rules), cfg.cdtype)
            h = L.apply_norm(lp["ln1"], x, cfg.norm)
            y, _, _ = tp_lib.manual_attention(
                lp["attn"], h, q_pos, cfg, rules, q_offset=off,
                prefix_len=prefix_len, buf=kbuf[:, i])
            x = _apply_mlp(lp, cfg, x + y, rules)
    last = final_logits(params, cfg, x[:, -1], rules)
    keep = kbuf[:, :, :, n_buf - max_len:]
    filled = min(S_tot, max_len)
    cache = [torch.stack([tp_lib.seq_shard(keep[j, i], rules, lay, filled)
                          for i in range(cfg.n_layers)]) for j in (0, 1)]
    del kbuf, keep
    length = torch.full((B,), S_tot, dtype=torch.int32, device=dev)
    return last, DecodeState(kv=KVCache(k=cache[0], v=cache[1],
                                        length=length))


def _fill_cache(cache: KVCache, i: int, k, v, window) -> None:
    """Write one layer's prefill keys and values into cache layer ``i`` of
    ``C`` slots, as the reference's ``pad_kv``: the last ``min(S, C)``
    positions, zero-padded when ``S < C``; a windowed cache is a ring
    keyed by absolute position mod ``C``."""
    C, S = cache.k.shape[2], k.shape[1]
    n = min(S, C)
    for dst, src in ((cache.k, k), (cache.v, v)):
        last = src[:, S - n:]
        if window and S >= C:
            last = torch.roll(last, S % C, dims=1)
        dst[i, :, :n] = last


def _prefill_whole(params, cfg: ArchConfig, tokens, *, max_len=None,
                   prefix_embeds=None, prefix_len=None, rules=None):
    """One pass over the prompt.  The attention layers' keys and values go
    into a zero cache of ``max_len`` positions (``min(max_len, window)``
    ring slots for the hybrid; a prompt longer than the cache keeps its
    last positions); the recurrent layers' final states into the stacked
    ``ssm`` / ``lru`` states.  ``length`` is S, clamped to the ring's size
    for the hybrid (the reference's; ROADMAP C4).  With ``rules`` (the
    recurrent families on a mesh) the rank's rows, its layers on its
    blocks, its states the rank's channels and the hybrid's ring every kv
    head (``manual_tp.all_heads``)."""
    if rules is not None:
        tokens, prefix_embeds = _rows(tokens, prefix_embeds, rules)
    x = _embed_with_prefix(params, cfg, tokens, prefix_embeds, rules)
    B, S, _ = x.shape
    dev = x.device
    max_len = max_len or S
    positions = torch.arange(S, device=dev)
    window = _window(cfg)
    cache_len = min(max_len, window) if window else max_len
    cache = ssm_st = lru_st = None
    if cfg.family == "ssm":
        ssm_st = ssm_lib.init_ssm_state(cfg, B, cfg.cdtype, cfg.n_layers,
                                        device=dev, rules=rules)
        for i in range(cfg.n_layers):
            x, _, st, _ = _apply_layer_full(_layer(params["stack"], i),
                                            cfg, "ssm", x, positions,
                                            rules=rules)
            _put_state(ssm_st, i, st)
    elif cfg.family == "hybrid":
        ng, n_tail = cfg.n_layers // 3, cfg.n_layers % 3
        cache = KVCache.init(ng, B, cache_len, cfg.n_kv_heads, cfg.head_dim_,
                             cfg.cdtype, device=dev)
        lru_st = rglru_lib.init_lru_state(cfg, B, cfg.cdtype,
                                          cfg.n_layers - ng, device=dev,
                                          rules=rules)
        groups = params["groups"]
        for i in range(ng):
            for j, name in enumerate(("rec1", "rec2")):
                x, _, st, _ = _apply_layer_full(_layer(groups[name], i),
                                                cfg, "rec", x, positions,
                                                rules=rules)
                _put_state(lru_st, 2 * i + j, st)
            x, (k, v), _, _ = _apply_layer_full(_layer(groups["attn"], i),
                                                cfg, "attn", x, positions,
                                                rules=rules)
            if rules is not None:
                lay = tp_lib.attn_layout(cfg, rules, (B, S))
                k, v = (tp_lib.all_heads(t, rules, lay) for t in (k, v))
            _fill_cache(cache, i, k, v, window)
        for j in range(n_tail):
            x, _, st, _ = _apply_layer_full(_layer(params["tail"], j), cfg,
                                            "rec", x, positions, rules=rules)
            _put_state(lru_st, 2 * ng + j, st)
    else:
        cache = KVCache.init(cfg.n_layers, B, max_len, cfg.n_kv_heads,
                             cfg.head_dim_, cfg.cdtype, device=dev)
        kind = layer_plan(cfg)[0]
        for i in range(cfg.n_layers):
            x, (k, v), _, _ = _apply_layer_full(_layer(params["stack"], i),
                                                cfg, kind, x, positions,
                                                prefix_len)
            _fill_cache(cache, i, k, v, None)
    last = final_logits(params, cfg, x[:, -1], rules)
    if cache is not None:
        n = min(S, cache_len) if window else S
        cache = cache._replace(length=torch.full(
            (B,), n, dtype=torch.int32, device=dev))
    return last, DecodeState(kv=cache, ssm=ssm_st, lru=lru_st)


# ---------------------------------------------------------------------------
# decode (one token)


def _decode_attn_layer(lp, cfg, x, k_cache, v_cache, length, window=None,
                       rules=None):
    """x: [B,1,D].  Returns x; the caches are updated in place.  With a
    window the cache is a ring: the new key goes into slot ``length %
    window`` and the query attends the ``min(length + 1, window)`` first
    slots, all unmasked by position, as the reference.  With ``rules``
    (the hybrid's ring on a mesh): ``manual_tp.decode_attention_ring``."""
    h = L.apply_norm(lp["ln1"], x, cfg.norm)
    if rules is not None:
        return x + tp_lib.decode_attention_ring(lp["attn"], h, k_cache,
                                                v_cache, length, cfg, rules,
                                                window)
    q, k, v = attn.qkv_proj(lp["attn"], h, length[:, None], cfg.rope_theta)
    if window:
        k_cache, v_cache = attn.cache_update_local(k_cache, v_cache, k, v,
                                                   length % window)
        kv_pos = torch.arange(window, device=x.device)
        o = attn.decode_attend_local(q[:, 0], k_cache, v_cache, kv_pos,
                                     torch.clamp(length + 1, max=window))
    else:
        k_cache, v_cache = attn.cache_update_local(k_cache, v_cache, k, v,
                                                   length)
        kv_pos = torch.arange(k_cache.shape[1], device=x.device)
        o = attn.decode_attend_local(q[:, 0], k_cache, v_cache, kv_pos,
                                     length + 1)
    x = x + attn.out_proj(lp["attn"], o[:, None])
    return x


def _decode_rec(lp, cfg, x, lru, i, rules=None):
    """One RG-LRU layer's step on lru slot ``i`` (updated in place)."""
    h = L.apply_norm(lp["ln1"], x, cfg.norm)
    y, st = rglru_lib.decode_rglru(lp["rec"], h, _state_at(lru, i), cfg=cfg,
                                   rules=rules)
    _put_state(lru, i, st)
    return _apply_mlp(lp, cfg, x + y, rules)


def decode_step(params, cfg: ArchConfig, tokens, state: DecodeState, *,
                mesh=None, rules=None):
    """tokens: [B,1].  Returns (logits [B,V] f32, new DecodeState).

    The layers' caches and recurrent states are updated in place (views of
    the stacked state), so ``state`` is consumed; the new state shares its
    tensors, with a cache length one larger.  With ``rules`` (and its
    ``mesh``) the rank's rows of ``tokens`` on the rank's blocks and state:
    :func:`_decode_sharded` for the sequence-sharded cache of the dense,
    moe and vlm families; the recurrent families' layers channel parallel
    and the hybrid's ring through ``manual_tp.decode_attention_ring``."""
    check_family(cfg)
    rules = sharded_rules(mesh, rules)
    if rules is not None:
        if cfg.family in CHUNKED_FAMILIES:
            return _decode_sharded(params, cfg, tokens, state, rules)
        tokens = tokens[batch_rows(tokens.shape[0], rules)]
    x = L.embed(params["embed"], tokens, cfg.cdtype, rules, cfg.vocab)
    if cfg.family == "ssm":
        axes = layer_axes(cfg, "ssm")
        for i in range(cfg.n_layers):
            lp = gather_fsdp(_layer(params["stack"], i), axes, cfg, rules)
            h = L.apply_norm(lp["ln1"], x, cfg.norm)
            y, st = ssm_lib.decode_ssm(lp["ssm"], h, cfg,
                                       _state_at(state.ssm, i), rules)
            _put_state(state.ssm, i, st)
            x = x + y
        return final_logits(params, cfg, x[:, 0], rules), state
    kc, vc, length = state.kv
    if cfg.family == "hybrid":
        window = cfg.hybrid.window
        check_cache_covers_window(cfg, kc.shape[2])
        ng = cfg.n_layers // 3
        groups = params["groups"]
        rec_axes, attn_axes = layer_axes(cfg, "rec"), layer_axes(cfg, "attn")

        def rec(x, stack, i, slot):
            lp = gather_fsdp(_layer(stack, i), rec_axes, cfg, rules)
            return _decode_rec(lp, cfg, x, state.lru, slot, rules)
        for i in range(ng):
            x = rec(x, groups["rec1"], i, 2 * i)
            x = rec(x, groups["rec2"], i, 2 * i + 1)
            lp = gather_fsdp(_layer(groups["attn"], i), attn_axes, cfg, rules)
            x = _decode_attn_layer(lp, cfg, x, kc[i], vc[i], length, window,
                                   rules)
            x = _apply_mlp(lp, cfg, x, rules)
        for j in range(cfg.n_layers % 3):
            x = rec(x, params["tail"], j, 2 * ng + j)
    else:
        for i in range(cfg.n_layers):
            lp = _layer(params["stack"], i)
            x = _decode_attn_layer(lp, cfg, x, kc[i], vc[i], length)
            x = _apply_mlp(lp, cfg, x)
    logits = final_logits(params, cfg, x[:, 0], rules)
    return logits, state._replace(
        kv=KVCache(k=kc, v=vc, length=length + 1))


def sharded_rules(mesh, rules):
    """The rules of a decode on ``mesh``: the port's shards follow the
    rules, so a mesh needs them, and they must be laid over that mesh."""
    if mesh is not None and (rules is None or rules.mesh is not mesh):
        raise ValueError("decode on a mesh takes the rules its params and "
                         "state were sharded by (rules= over that mesh)")
    return rules


def _decode_sharded(params, cfg: ArchConfig, tokens, state: DecodeState,
                    rules):
    """One decode step on a mesh: the rank's rows of ``tokens``, each
    layer's q, k and v gathered over ``"model"``, the new keys and values
    written on the shard that owns slot ``length``, the partitioned
    attention over every shard (``decode_attend_partitioned``), then the
    row-parallel output projection and the tensor-parallel MLP
    (``manual_tp``) or the expert-parallel experts (``moe``).  Returns the rank's rows' logits [B_loc, V]."""
    kc, vc, length = state.kv
    tokens = tokens[batch_rows(tokens.shape[0], rules)]
    x = L.embed(params["embed"], tokens, cfg.cdtype, rules, cfg.vocab)
    axes = layer_axes(cfg, layer_plan(cfg)[0])
    for i in range(cfg.n_layers):
        lp = gather_fsdp(_layer(params["stack"], i), axes, cfg, rules)
        h = L.apply_norm(lp["ln1"], x, cfg.norm)
        x = x + tp_lib.decode_attention(lp["attn"], h, kc[i], vc[i], length,
                                        cfg, rules)
        x = _apply_mlp(lp, cfg, x, rules)
    logits = final_logits(params, cfg, x[:, 0], rules)
    return logits, state._replace(
        kv=KVCache(k=kc, v=vc, length=length + 1))
