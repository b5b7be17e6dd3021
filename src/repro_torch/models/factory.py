"""Model API of the LM stack.

The port of the JAX package's ``repro.models.factory`` for serving:
``build_model(cfg)`` returns a ``Model`` whose ``init`` draws parameters on
a device and whose ``prefill``/``decode`` are functions of (params,
batch/state).  ``logits``, ``loss`` and ``cross_entropy`` wait for the
training slice (ROADMAP A14).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.engine import resolve_device
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import KVCache
from repro_torch.models.transformer import DecodeState


@dataclasses.dataclass
class Model:
    cfg: ArchConfig

    # -- init ---------------------------------------------------------------
    def init(self, generator: Optional[torch.Generator] = None,
             device=None) -> dict:
        """Parameters drawn from ``generator`` (default: seeded 0) on
        ``device`` — the card unless the caller asks for the CPU.  Returns
        the params tree (the reference also returns logical axes, which
        only its sharding reads)."""
        dev = resolve_device(device)
        tfm.check_family(self.cfg)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        return tfm.init_params(generator, self.cfg, dev)

    # -- serve --------------------------------------------------------------
    def prefill(self, params, batch, *, max_len=None):
        return tfm.prefill(params, self.cfg, batch["tokens"], max_len=max_len)

    def decode(self, params, tokens, state):
        return tfm.decode_step(params, self.cfg, tokens, state)

    def n_attn_layers(self) -> int:
        tfm.check_family(self.cfg)
        if self.cfg.family == "hybrid":
            return self.cfg.n_layers // 3
        if self.cfg.family == "ssm":
            return 0
        return self.cfg.n_layers

    def decode_state_specs(self, batch: int, max_len: int) -> DecodeState:
        """Shapes and dtypes of the decode state, as ``(shape, dtype)``
        pairs in the state's tree: dense and moe one KV cache of
        ``n_layers``; ssm a stacked ``SSMState`` and no cache;
        hybrid a ring cache of ``min(max_len, window)`` slots for its
        attention layers and a stacked ``LRUState`` for its recurrent ones
        (``max_len < window`` raises: that cache cannot be decoded, see
        ``transformer.check_cache_covers_window``)."""
        cfg = self.cfg
        dt = cfg.cdtype
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

    def decode_state_init(self, batch: int, max_len: int, *, filled=0,
                          device=None) -> DecodeState:
        """Concrete zero state on ``device`` (the card unless asked for the
        CPU), every sequence's cache length ``filled``."""
        dev = resolve_device(device)
        specs = self.decode_state_specs(batch, max_len)

        def zeros(spec):
            return None if spec is None else type(spec)(
                *(torch.zeros(shape, dtype=dt, device=dev)
                  for shape, dt in spec))
        st = DecodeState(*(zeros(spec) for spec in specs))
        if st.kv is not None:
            st.kv.length.fill_(filled)
        return st


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg)
