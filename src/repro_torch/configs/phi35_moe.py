"""Phi-3.5-MoE-42B (6.6B active) [moe]: 16 experts, top-2, GQA (kv=8).
[hf:microsoft/Phi-3.5-MoE-instruct; hf]"""
from repro_torch.configs.base import ArchConfig, MoEConfig, register

CONFIG = register(ArchConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=6400,
    vocab=32064, norm="layernorm",
    moe=MoEConfig(num_experts=16, top_k=2, expert_d_ff=6400),
    microbatches=4,
    source="hf:microsoft/Phi-3.5-MoE-instruct; hf",
))
