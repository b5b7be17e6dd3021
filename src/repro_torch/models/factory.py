"""Model API of the LM stack.

The port of the JAX package's ``repro.models.factory``: ``build_model(cfg)``
returns a ``Model`` whose ``init`` draws parameters on a device and whose
``loss`` (train), ``prefill`` and ``decode`` (serve) are functions of
(params, batch/state), for every family: the decoder-only ones through
``models/transformer.py`` (a vlm batch adds ``image_embeds [B, P, D]``,
attended with the prefix-LM mask over ``cfg.num_image_tokens``
positions), encdec through ``models/encdec.py`` (a batch adds ``frames
[B, F, D]``).

Two sets of parameter dtypes.  ``init()`` stores the leaves as serving
reads them (``transformer.storage_dtype``: the block matmul weights in the
compute dtype, bit-identical to the reference's cast at every use, half
the bytes).  ``init(train=True)`` stores them in the reference's own dtypes
(``cfg.pdtype``, float32; the ``_KEEP_F32`` leaves float32), which is
what it trains: its AdamW keeps no master copy of float32 leaves, and
training the serving storage would switch the master-weight path on and
change the numbers.

On a mesh every method takes ``rules`` (``models/sharding.AxisRules``
over a ``launch/mesh.Mesh``; ``launch/steps.rules_for`` gives the
reference's) and a rank's params: ``shard_params`` (or
``convert.lm_params_from_arrays(..., rules=)``) cuts them from the whole
ones by ``param_axes``.  ``decode_state_init`` gives the rank its shard of
the state by ``state_logical_axes``: the KV cache's sequence over
``"model"`` (the hybrid's ring stays whole), the recurrent states'
channels over ``"model"``, the batch over ``"data"``.  ``loss(params,
batch, rules)`` trains on a mesh: the rank's rows, its part of the
reference's global mean (see :meth:`Model.loss`).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch

from repro_torch.configs.shapes import ShapeConfig
from repro_torch.configs.base import ArchConfig
from repro_torch.core.engine import resolve_device
from repro_torch.models import encdec as encdec_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import KVCache
from repro_torch.models.sharding import (batch_axes, batch_rows, local_shape,
                                         shard_tree)
from repro_torch.models.transformer import DecodeState


def cross_entropy(logits, labels, mask, count=None):
    """logits: [B,S,V] f32; labels: [B,S] int; mask: [B,S].  The masked
    sum of ``logsumexp - gold`` over ``max(count, 1)``, ``count`` the
    mask's sum unless given (a mesh's: the sum over every rank's rows)."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = (logz - gold) * mask
    count = torch.sum(mask) if count is None else count
    return torch.sum(nll) / torch.clamp(count, min=1.0)


def _sum_over(x: torch.Tensor, axes: tuple, mesh) -> torch.Tensor:
    """``x`` summed over the mesh ``axes``, no gradient."""
    x = x.detach()
    for ax in axes:
        if mesh.shape[ax] > 1:
            x = mesh.all_reduce_sum(x, ax)
    return x


@dataclasses.dataclass
class Model:
    cfg: ArchConfig
    aux_weight: float = 0.01

    # -- init ---------------------------------------------------------------
    def init(self, generator: Optional[torch.Generator] = None,
             device=None, *, train: bool = False) -> dict:
        """Parameters drawn from ``generator`` (default: seeded 0) on
        ``device`` — the card unless the caller asks for the CPU — in the
        serving storage dtypes, or with ``train`` in the reference's
        (module docstring).  Returns the params tree (the reference also
        returns logical axes, which only its sharding reads)."""
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        if self.cfg.family == "encdec":
            return encdec_lib.init_encdec(generator, self.cfg, dev, train)
        tfm.check_family(self.cfg)
        return tfm.init_params(generator, self.cfg, dev, train)

    def param_axes(self) -> dict:
        """The reference's logical axes tree of the params (its
        ``init(key)[1]``), leaf for leaf."""
        if self.cfg.family == "encdec":
            return encdec_lib.param_axes(self.cfg)
        return tfm.param_axes(self.cfg)

    def shard_params(self, params: dict, rules) -> dict:
        """This rank's block of every leaf of whole ``params`` by
        :meth:`param_axes` and ``rules`` (``sharding.local_shard``)."""
        return shard_tree(params, self.param_axes(), rules)

    # -- train --------------------------------------------------------------
    def logits(self, params, batch, rules=None, remat=True):
        """(logits [B, S_text, V] float32, aux): a vlm's image positions
        are dropped from its logits; encdec reads ``batch["frames"]``.
        With ``rules``: the rank's rows."""
        cfg = self.cfg
        if cfg.family == "encdec":
            return encdec_lib.forward(params, cfg, batch["tokens"],
                                      batch["frames"], remat=remat,
                                      rules=rules)
        if cfg.family == "vlm":
            lg, aux = tfm.forward(params, cfg, batch["tokens"],
                                  prefix_embeds=batch["image_embeds"],
                                  prefix_len=cfg.num_image_tokens,
                                  remat=remat, rules=rules)
            return lg[:, cfg.num_image_tokens:], aux
        return tfm.forward(params, cfg, batch["tokens"], remat=remat,
                           rules=rules)

    def loss(self, params, batch, rules=None, remat=True):
        """(loss, {"loss", "ce", "aux"}): the masked cross entropy plus
        ``aux_weight`` times the moe aux loss.

        With ``rules`` (a rank's params; the whole batch on every rank)
        each rank takes its rows of the batch over the batch axes, which
        must split it: its cross entropy is its rows' nll summed over the
        mask's count summed over those axes (no gradient through the
        count), the reference's global mean split into parts.  The moe
        aux loss is the global batch's on every rank (``moe.apply_moe``:
        its statistics summed over the batch axes, a sum whose gradient
        passes through), so each rank's gradient of it covers its own
        rows.  The loss returned is the rank's part, whose gradients
        summed over the batch axes are the reference's; the metrics are
        the whole batch's: ``ce`` the parts summed, ``loss`` that plus
        ``aux_weight`` times the aux, counted once."""
        if rules is None:
            logits, aux = self.logits(params, batch, remat=remat)
            ce = cross_entropy(logits, batch["labels"], batch["loss_mask"])
            loss = ce + self.aux_weight * aux
            return loss, {"loss": loss, "ce": ce, "aux": aux}
        n = batch["labels"].shape[0]
        axes = batch_axes(rules)
        shards = math.prod(rules.mesh.shape[a] for a in axes)
        if n % shards:
            raise ValueError(f"a batch of {n} rows does not split over the "
                             f"{shards} ranks of the batch axes {axes}")
        rows = batch_rows(n, rules)
        mask = batch["loss_mask"][rows]
        count = _sum_over(torch.sum(mask), axes, rules.mesh)
        logits, aux = self.logits(params, batch, rules, remat)
        ce = cross_entropy(logits, batch["labels"][rows], mask, count)
        loss = ce + self.aux_weight * aux
        aux = aux.detach()
        ce_all = _sum_over(ce, axes, rules.mesh)
        return loss, {"loss": ce_all + self.aux_weight * aux, "ce": ce_all,
                      "aux": aux}

    def param_specs(self, train: bool = False) -> dict:
        """The whole params as ``(shape, dtype)`` leaves, in the storage
        dtypes of ``init`` (``train``: the reference's), a tree congruent
        with :meth:`param_axes` (``init`` on the meta device: nothing is
        drawn; kept per config, a fresh tree each call)."""
        def copy(t):
            return {k: copy(v) for k, v in t.items()} \
                if isinstance(t, dict) else t
        return copy(_param_specs(self.cfg, train))

    def param_shapes(self) -> dict:
        """The whole params' shapes (:meth:`param_specs`' shapes)."""
        def shapes(t):
            return ({k: shapes(v) for k, v in t.items()}
                    if isinstance(t, dict) else t[0])
        return shapes(self.param_specs(train=True))

    # -- serve --------------------------------------------------------------
    def prefill(self, params, batch, *, max_len=None, rules=None):
        """(last logits, decode state); with ``rules`` the rank's rows of
        both (its sequence shard of the cache)."""
        cfg = self.cfg
        if cfg.family == "encdec":
            return encdec_lib.prefill(params, cfg, batch["tokens"],
                                      batch["frames"], max_len=max_len,
                                      rules=rules)
        if cfg.family == "vlm":
            return tfm.prefill(params, cfg, batch["tokens"], max_len=max_len,
                               prefix_embeds=batch["image_embeds"],
                               prefix_len=cfg.num_image_tokens, rules=rules)
        return tfm.prefill(params, cfg, batch["tokens"], max_len=max_len,
                           rules=rules)

    def decode(self, params, tokens, state, *, mesh=None, rules=None):
        """tokens: the whole batch's [B, 1]; with ``rules`` (and its
        ``mesh``) ``state`` is the rank's shard and the logits are its
        rows'."""
        if self.cfg.family == "encdec":
            return encdec_lib.decode_step(params, self.cfg, tokens, state,
                                          mesh=mesh, rules=rules)
        return tfm.decode_step(params, self.cfg, tokens, state, mesh=mesh,
                               rules=rules)

    def n_attn_layers(self) -> int:
        """Attention layers that hold a self-attention KV cache (encdec:
        the decoder's)."""
        if self.cfg.family == "encdec":
            return self.cfg.n_layers
        tfm.check_family(self.cfg)
        if self.cfg.family == "hybrid":
            return self.cfg.n_layers // 3
        if self.cfg.family == "ssm":
            return 0
        return self.cfg.n_layers

    def decode_state_specs(self, batch: int, max_len: int):
        """Shapes and dtypes of the decode state, as ``(shape, dtype)``
        pairs in the state's tree: dense, moe and vlm one KV cache of
        ``n_layers``; ssm a stacked ``SSMState`` and no cache;
        hybrid a ring cache of ``min(max_len, window)`` slots for its
        attention layers and a stacked ``LRUState`` for its recurrent ones
        (``max_len < window`` raises: that cache cannot be decoded, see
        ``transformer.check_cache_covers_window``); encdec an
        ``EncDecState``: the decoder's cache of ``max_len`` and the cross
        keys and values of ``N_FRAMES_PAD`` frames."""
        cfg = self.cfg
        dt = cfg.cdtype
        if cfg.family == "encdec":
            return encdec_lib.state_specs(cfg, batch, max_len, dt)
        kv = ssm = lru = None
        cache_len = max_len
        if cfg.family == "ssm":
            ssm = ssm_lib.ssm_state_specs(cfg, batch, dt, cfg.n_layers)
        elif cfg.family == "hybrid":
            tfm.check_cache_covers_window(cfg, max_len)
            lru = rglru_lib.lru_state_specs(
                cfg, batch, dt, cfg.n_layers - self.n_attn_layers())
            cache_len = min(max_len, cfg.hybrid.window)
        if cfg.family != "ssm":
            shape = (self.n_attn_layers(), batch, cache_len, cfg.n_kv_heads,
                     cfg.head_dim_)
            kv = KVCache(k=(shape, dt), v=(shape, dt),
                         length=((batch,), torch.int32))
        return DecodeState(kv=kv, ssm=ssm, lru=lru)

    def decode_state_local_specs(self, batch: int, max_len: int, *,
                                 rules=None):
        """:meth:`decode_state_specs` with ``rules`` cut to the rank's
        shard of each leaf (:func:`state_logical_axes`)."""
        specs = self.decode_state_specs(batch, max_len)
        if rules is None:
            return specs
        if self.cfg.family not in ("hybrid", "ssm"):
            tfm.check_seq_shards(max_len, rules)
        axes = state_logical_axes(self, specs)

        def local(spec, ax):
            if spec is None:
                return None
            if isinstance(spec[1], torch.dtype):     # a (shape, dtype) leaf
                return local_shape(spec[0], ax, rules), spec[1]
            return type(spec)(*(local(s, a) for s, a in zip(spec, ax)))
        return local(specs, axes)

    def decode_state_init(self, batch: int, max_len: int, *, filled=0,
                          device=None, rules=None):
        """Concrete zero state on ``device`` (the card unless asked for the
        CPU), every sequence's cache length ``filled``; with ``rules`` the
        rank's shard of it (:meth:`decode_state_local_specs`)."""
        st = state_zeros(self.decode_state_local_specs(batch, max_len,
                                                       rules=rules),
                         resolve_device(device))
        kv = st.self_kv if self.cfg.family == "encdec" else st.kv
        if kv is not None:
            kv.length.fill_(filled)
        return st


def state_zeros(spec, device):
    """Zero tensors on ``device`` for a tree of ``(shape, dtype)`` leaves in
    NamedTuples (None leaves stay None)."""
    if spec is None:
        return None
    if isinstance(spec[1], torch.dtype):
        return torch.zeros(spec[0], dtype=spec[1], device=device)
    return type(spec)(*(state_zeros(s, device) for s in spec))


@functools.lru_cache(maxsize=64)
def _param_specs(cfg: ArchConfig, train: bool) -> dict:
    meta = torch.device("meta")
    if cfg.family == "encdec":
        p = encdec_lib.init_encdec(None, cfg, meta, train)
    else:
        tfm.check_family(cfg)
        p = tfm.init_params(None, cfg, meta, train=train)

    def specs(t):
        return ({k: specs(v) for k, v in t.items()}
                if isinstance(t, dict) else (tuple(t.shape), t.dtype))
    return specs(p)


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg)


def batch_logical_axes(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """The logical axes of a batch of ``shape`` (the reference's):
    ``"batch"`` then ``"null"`` for each input."""
    ndims = {"tokens": 2}
    if shape.kind != "decode":
        if cfg.family == "encdec":
            ndims["frames"] = 3
        elif cfg.family == "vlm":
            ndims["image_embeds"] = 3
        if shape.kind == "train":
            ndims.update(labels=2, loss_mask=2)
    return {k: ("batch",) + ("null",) * (n - 1) for k, n in ndims.items()}


def state_logical_axes(model: Model, specs):
    """Logical axes tree matching ``decode_state_specs``: the KV caches'
    sequence over ``"seq_kv"`` (the hybrid's window cache stays local:
    ``"null"``, whole on every rank of the model axis), the batch over
    ``"batch"``, the recurrent states' channels over ``"inner"`` (the
    rank's channels on a mesh, as its blocks of the weights)."""
    cfg = model.cfg
    seq = "null" if cfg.family == "hybrid" else "seq_kv"
    kv_axes = KVCache(k=("layers", "batch", seq, "null", "null"),
                      v=("layers", "batch", seq, "null", "null"),
                      length=("batch",))
    if cfg.family == "encdec":
        return encdec_lib.EncDecState(
            self_kv=kv_axes,
            cross_k=("layers", "batch", "null", "null", "null"),
            cross_v=("layers", "batch", "null", "null", "null"))
    return DecodeState(
        kv=kv_axes if specs.kv is not None else None,
        ssm=(ssm_lib.SSMState(conv=("layers", "batch", "null", "inner"),
                              h=("layers", "batch", "inner", "null"))
             if specs.ssm is not None else None),
        lru=(rglru_lib.LRUState(conv=("layers", "batch", "null", "inner"),
                                h=("layers", "batch", "inner"))
             if specs.lru is not None else None))
