"""xLSTM-1.3b — sLSTM + mLSTM blocks at the paper's 7:1 ratio
[arXiv:2405.04517]. 48L d_model=2048 4H (kv=4) d_ff=0 (blocks carry their
own projections) vocab=50304. A copy of ``repro/configs/xlstm_1_3b.py``."""
from repro_torch.models.backbone.config import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b",
    arch_type="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    slstm_period=8,
    source="arXiv:2405.04517 (xLSTM)",
)
