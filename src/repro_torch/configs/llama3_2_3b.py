"""Llama-3.2-3B — small llama3 dense GQA [hf:meta-llama/Llama-3.2-1B family].
28L d_model=3072 24H (kv=8) d_ff=8192 vocab=128256. A copy of
``repro/configs/llama3_2_3b.py``."""
from repro_torch.models.backbone.config import ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-3b",
    arch_type="dense",
    num_layers=28,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=128256,
    rope_theta=5e5,
    tie_embeddings=True,
    source="hf:meta-llama/Llama-3.2-1B (family card)",
)
