"""Whisper-base — encoder-decoder audio transformer [arXiv:2212.04356].
6L (enc + dec) d_model=512 8H (kv=8) d_ff=2048 vocab=51865. The
mel-spectrogram + conv frontend is a stub: the encoder takes precomputed
frame embeddings (B, 1500, 512) (``batch["frames"]``). A copy of
``repro/configs/whisper_base.py``."""
from repro_torch.models.backbone.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base",
    arch_type="audio",
    num_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    is_encoder_decoder=True,
    num_encoder_layers=6,
    encoder_seq_len=1500,
    source="arXiv:2212.04356 (Whisper)",
)
