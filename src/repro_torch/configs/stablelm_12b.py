"""StableLM-2-12B [dense]: GQA (kv=8), SwiGLU.
[hf:stabilityai/stablelm-2-1_6b family; hf]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="stablelm-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, d_ff=13824,
    vocab=100352, norm="layernorm",
    microbatches=4,
    source="hf:stabilityai/stablelm-2-1_6b; hf",
))
