"""StarCoder2-7B [dense]: GQA (kv=4), RoPE, non-gated GELU FFN.
[arXiv:2402.19173; hf]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="starcoder2-7b", family="dense",
    n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4, d_ff=18432,
    vocab=49152, act="gelu", gated_mlp=False, norm="layernorm",
    qkv_bias=True,
    microbatches=4,
    source="arXiv:2402.19173; hf",
))
