"""Architecture configs of the port: ``get_config("zamba2-7b")``.

The port's backbone serves (and trains) every architecture of the JAX
package's registry: zamba2-7b (mamba2 + shared attention), the dense GQA
models qwen3-4b, qwen3-8b and qwen3-32b (qk-norm) and llama3.2-3b (tied
embeddings), the MoE models olmoe-1b-7b (64 experts, top 8, qk-norm) and
phi3.5-moe (16 experts, top 2), qwen2-vl-2b (M-RoPE, vision prefix),
whisper-base (bidirectional encoder, cross-attention) and xlstm-1.3b
(mLSTM, sLSTM). An unknown name raises a ``KeyError``.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.llama3_2_3b import CONFIG as _llama3_2_3b
from repro_torch.configs.olmoe_1b_7b import CONFIG as _olmoe_1b_7b
from repro_torch.configs.phi3_5_moe import CONFIG as _phi3_5_moe
from repro_torch.configs.qwen2_vl_2b import CONFIG as _qwen2_vl_2b
from repro_torch.configs.qwen3_4b import CONFIG as _qwen3_4b
from repro_torch.configs.qwen3_8b import CONFIG as _qwen3_8b
from repro_torch.configs.qwen3_32b import CONFIG as _qwen3_32b
from repro_torch.configs.whisper_base import CONFIG as _whisper_base
from repro_torch.configs.xlstm_1_3b import CONFIG as _xlstm_1_3b
from repro_torch.configs.zamba2_7b import CONFIG as _zamba2
from repro_torch.models.backbone.config import INPUT_SHAPES, ArchConfig, InputShape

REGISTRY: Dict[str, ArchConfig] = {
    c.name: c for c in [_zamba2, _qwen3_4b, _qwen3_8b, _qwen3_32b, _llama3_2_3b, _olmoe_1b_7b,
                        _phi3_5_moe, _qwen2_vl_2b, _whisper_base, _xlstm_1_3b]}

ARCH_NAMES = tuple(REGISTRY)


def get_config(name: str) -> ArchConfig:
    if name in REGISTRY:
        return REGISTRY[name]
    raise KeyError(f"unknown arch {name!r}; available: {sorted(REGISTRY)}")


__all__ = ["ARCH_NAMES", "INPUT_SHAPES", "REGISTRY", "ArchConfig", "InputShape", "get_config"]
