"""Phi-3.5-MoE (42B total / 6.6B active) — 16-expert top-2 MoE
[hf:microsoft/Phi-3.5-MoE-instruct]. 32L d_model=4096 32H (kv=8)
per-expert d_ff=6400 vocab=32064. A copy of ``repro/configs/phi3_5_moe.py``."""
from repro_torch.models.backbone.config import ArchConfig

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    arch_type="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    vocab_size=32064,
    num_experts=16,
    num_experts_per_tok=2,
    d_expert=6400,
    source="hf:microsoft/Phi-3.5-MoE-instruct",
)
