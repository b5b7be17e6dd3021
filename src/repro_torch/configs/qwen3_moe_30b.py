"""Qwen3-MoE-30B (3B active) [moe]: 128 experts, top-8, GQA (kv=4),
head_dim=128 explicit. [hf:Qwen/Qwen3-30B-A3B; hf]"""
from repro_torch.configs.base import ArchConfig, MoEConfig, register

CONFIG = register(ArchConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, d_ff=768,
    vocab=151936, head_dim=128,
    moe=MoEConfig(num_experts=128, top_k=8, expert_d_ff=768),
    microbatches=4,
    source="hf:Qwen/Qwen3-30B-A3B; hf",
))
