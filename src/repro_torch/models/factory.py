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
        return self.cfg.n_layers

    def decode_state_specs(self, batch: int, max_len: int) -> DecodeState:
        """Shapes and dtypes of the decode state, as ``(shape, dtype)``
        pairs in the state's tree."""
        cfg = self.cfg
        kv = (self.n_attn_layers(), batch, max_len, cfg.n_kv_heads,
              cfg.head_dim_)
        return DecodeState(kv=KVCache(k=(kv, cfg.cdtype), v=(kv, cfg.cdtype),
                                      length=((batch,), torch.int32)))

    def decode_state_init(self, batch: int, max_len: int, *, filled=0,
                          device=None) -> DecodeState:
        """Concrete zero state on ``device`` (the card unless asked for the
        CPU), every sequence's length ``filled``."""
        dev = resolve_device(device)
        specs = self.decode_state_specs(batch, max_len).kv
        kv = KVCache(
            k=torch.zeros(specs.k[0], dtype=specs.k[1], device=dev),
            v=torch.zeros(specs.v[0], dtype=specs.v[1], device=dev),
            length=torch.full(specs.length[0], filled, dtype=torch.int32,
                              device=dev))
        return DecodeState(kv=kv)


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg)
