"""OLMoE-1B-7B — 64-expert top-8 MoE [arXiv:2409.02060].
16L d_model=2048 16H (kv=16) per-expert d_ff=1024 vocab=50304. A copy of
``repro/configs/olmoe_1b_7b.py``."""
from repro_torch.models.backbone.config import ArchConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    arch_type="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1024,
    vocab_size=50304,
    qk_norm=True,
    num_experts=64,
    num_experts_per_tok=8,
    d_expert=1024,
    source="arXiv:2409.02060 (OLMoE)",
)
