"""PaliGemma-3B [vlm]: SigLIP vision frontend (STUB per spec — the request
provides precomputed patch embeddings) + Gemma-2B decoder backbone.
[arXiv:2407.07726; hf]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, d_ff=16384,
    vocab=257216, head_dim=256, act="gelu", gated_mlp=True,
    tie_embeddings=True, num_image_tokens=256,
    microbatches=2,
    source="arXiv:2407.07726; hf",
))
