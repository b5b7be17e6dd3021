"""Whisper-base [audio]: encoder-decoder; conv audio frontend is a STUB per
spec (the request provides precomputed frame embeddings).
[arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="whisper-base", family="encdec",
    n_layers=6, n_enc_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
    d_ff=2048, vocab=51865, norm="layernorm", act="gelu", gated_mlp=False,
    cross_attention=True, tie_embeddings=True,
    microbatches=2,
    source="arXiv:2212.04356; unverified",
))
