"""Falcon-Mamba-7B [ssm]: attention-free Mamba-1, ssm_state=16; subquadratic
(runs the long_500k shape). [arXiv:2410.05355; unverified]"""
from repro_torch.configs.base import ArchConfig, SSMConfig, register

CONFIG = register(ArchConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=1, n_kv_heads=1, d_ff=0,
    vocab=65024,
    ssm=SSMConfig(state_dim=16, conv_width=4, expand=2),
    subquadratic=True,
    microbatches=4,
    source="arXiv:2410.05355; unverified",
))
