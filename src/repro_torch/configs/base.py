"""Architecture config system.

The port of the JAX package's ``repro.configs.base``: one ``ArchConfig``
describes any architecture of the zoo; family-specific fields are optional.
``reduced()`` produces the CPU-test variant of the same family (small
layers/width/experts/vocab).  ``pdtype``/``cdtype`` are torch dtypes.

The registry holds every config of the reference: the four ``dense``
decoders, the ``hybrid`` recurrentgemma-2b, the ``ssm`` falcon-mamba-7b,
the ``moe`` qwen3-moe-30b-a3b and phi3.5-moe-42b-a6.6b, the ``vlm``
paligemma-3b and the ``encdec`` whisper-base.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    expert_d_ff: int          # per-expert FFN width
    capacity_factor: float = 1.25
    router_jitter: float = 0.0


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 16
    conv_width: int = 4
    expand: int = 2
    dt_rank: Optional[int] = None  # default d_model // 16


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    window: int = 2048         # local attention window
    pattern: Tuple[str, ...] = ("recurrent", "recurrent", "attention")
    lru_width: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None          # default d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm: str = "rmsnorm"                   # or "layernorm"
    act: str = "silu"                       # or "gelu"
    gated_mlp: bool = True                  # SwiGLU-style (False: plain MLP)
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    # enc-dec (whisper): encoder depth/width mirror decoder unless set
    n_enc_layers: Optional[int] = None
    cross_attention: bool = False
    # vlm: number of image-patch positions provided by the (stub) frontend
    num_image_tokens: int = 0
    # dtypes
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # gradient-accumulation microbatches for the train_4k shape (memory fit)
    microbatches: int = 1
    # long-context capability: full attention is quadratic; SSM/hybrid are not
    subquadratic: bool = False
    source: str = ""

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def num_params(self) -> int:
        """Analytic parameter count (embedding + blocks)."""
        d, v = self.d_model, self.vocab
        hd = self.head_dim_
        n = v * d                       # embedding
        if not self.tie_embeddings:
            n += v * d                  # unembed
        att = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d
        if self.family == "ssm":
            s = self.ssm or SSMConfig()
            din = s.expand * d
            dtr = s.dt_rank or d // 16
            per = (d * 2 * din + s.conv_width * din
                   + din * (dtr + 2 * s.state_dim) + dtr * din
                   + din * s.state_dim + din + din * d)
            return n + self.n_layers * (per + 2 * d)
        if self.family == "moe":
            m = self.moe
            ff = (3 if self.gated_mlp else 2) * d * m.expert_d_ff
            per = att + d * m.num_experts + m.num_experts * ff + 2 * d
            return n + self.n_layers * per
        ff = (3 if self.gated_mlp else 2) * d * self.d_ff
        per = att + ff + 2 * d
        if self.family == "hybrid":
            # roughly: attention layers ~1/3, recurrent ~2/3 w/ similar size
            return n + self.n_layers * (per + d * d // 2)
        total = n + self.n_layers * per
        if self.family == "encdec":
            enc = (self.n_enc_layers or self.n_layers) * (att + ff + 2 * d)
            total += enc + self.n_layers * att  # cross attention
        return total

    def active_params(self) -> int:
        """MoE: params touched per token (for MODEL_FLOPS = 6*N_active*D,
        ``launch/roofline.model_flops``); every other family: all of
        them."""
        if self.family != "moe":
            return self.num_params()
        d = self.d_model
        hd = self.head_dim_
        m = self.moe
        att = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d
        ff = (3 if self.gated_mlp else 2) * d * m.expert_d_ff
        per = att + d * m.num_experts + m.top_k * ff + 2 * d
        n = self.vocab * d * (1 if self.tie_embeddings else 2)
        return n + self.n_layers * per

    def reduced(self) -> "ArchConfig":
        """Same family, tiny dims — the CPU test configuration."""
        kw = dict(
            # hybrid: one full (rec, rec, attn) group + one tail rec layer
            n_layers=4 if self.family == "hybrid" else min(self.n_layers, 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(4, max(1, self.n_kv_heads * 4 // self.n_heads)),
            d_ff=128,
            vocab=256,
            head_dim=16,
        )
        if self.moe:
            kw["moe"] = MoEConfig(num_experts=min(self.moe.num_experts, 4),
                                  top_k=min(self.moe.top_k, 2),
                                  expert_d_ff=64)
        if self.ssm:
            kw["ssm"] = SSMConfig(state_dim=4, conv_width=4, expand=2,
                                  dt_rank=8)
        if self.hybrid:
            kw["hybrid"] = HybridConfig(window=16, pattern=self.hybrid.pattern)
        if self.n_enc_layers:
            kw["n_enc_layers"] = 2
        if self.num_image_tokens:
            kw["num_image_tokens"] = 8
        return dataclasses.replace(self, **kw)


_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    if not _REGISTRY:
        _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"no config {name!r} in the port (it has "
                       f"{sorted(_REGISTRY)})")
    return _REGISTRY[name]


def list_configs() -> list[str]:
    if not _REGISTRY:
        _load_all()
    return sorted(_REGISTRY)


def _load_all():
    # importing the modules registers the configs
    from repro_torch.configs import (  # noqa: F401
        falcon_mamba_7b, mistral_large_123b, paligemma_3b, phi35_moe,
        qwen2_72b, qwen3_moe_30b, recurrentgemma_2b, stablelm_12b,
        starcoder2_7b, whisper_base)
