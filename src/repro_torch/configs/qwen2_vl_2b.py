"""Qwen2-VL-2B — VLM with M-RoPE and dynamic resolution [arXiv:2409.12191].
28L d_model=1536 12H (kv=2) d_ff=8960 vocab=151936. The ViT vision encoder
is a stub: a batch carries precomputed patch embeddings (B, 256, 1536),
which ``vision_proj`` projects. A copy of ``repro/configs/qwen2_vl_2b.py``."""
from repro_torch.models.backbone.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-2b",
    arch_type="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    mrope=True,
    num_vision_tokens=256,
    rope_theta=1e6,
    tie_embeddings=True,
    source="arXiv:2409.12191 (Qwen2-VL)",
)
