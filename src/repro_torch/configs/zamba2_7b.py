"""Zamba2-7B — Mamba2 backbone with a SHARED attention block applied every
6th layer [arXiv:2411.15242]. 81L d_model=3584 32H (kv=32) d_ff=14336
vocab=32000, ssm_state=64. A copy of ``repro/configs/zamba2_7b.py``."""
from repro_torch.models.backbone.config import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    arch_type="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    hybrid_attn_period=6,
    shared_attn=True,
    source="arXiv:2411.15242 (Zamba2)",
)
