"""Qwen3-4B — dense GQA with qk-norm [hf:Qwen/Qwen3-8B family].
36L d_model=2560 32H (kv=8) d_ff=9728 vocab=151936. A copy of
``repro/configs/qwen3_4b.py``."""
from repro_torch.models.backbone.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-4b",
    arch_type="dense",
    num_layers=36,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1e6,
    source="hf:Qwen/Qwen3-8B (family card)",
)
