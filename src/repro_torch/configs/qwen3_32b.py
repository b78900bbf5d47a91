"""Qwen3-32B — dense GQA with qk-norm [hf:Qwen/Qwen3-8B family].
64L d_model=5120 64H (kv=8) d_ff=25600 vocab=151936. A copy of
``repro/configs/qwen3_32b.py``."""
from repro_torch.models.backbone.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-32b",
    arch_type="dense",
    num_layers=64,
    d_model=5120,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1e6,
    source="hf:Qwen/Qwen3-8B (family card)",
)
