"""RecurrentGemma-2B [hybrid]: RG-LRU + local attention 1:2 pattern
(recurrent, recurrent, attention), window 2048, MQA (kv=1); subquadratic.
[arXiv:2402.19427; hf]"""
from repro_torch.configs.base import ArchConfig, HybridConfig, register

CONFIG = register(ArchConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, d_ff=7680,
    vocab=256000, head_dim=256, act="gelu",
    hybrid=HybridConfig(window=2048,
                        pattern=("recurrent", "recurrent", "attention")),
    tie_embeddings=True, subquadratic=True,
    microbatches=2,
    source="arXiv:2402.19427; hf",
))
