"""Architecture configs of the port: ``get_config("zamba2-7b")``.

The port's backbone serves (and trains) the architectures whose blocks
reach flash attention, GLA and RMSNorm without MoE, enc-dec or vision
modules: zamba2-7b (mamba2 + shared attention), the dense GQA models
qwen3-4b, qwen3-8b and qwen3-32b (qk-norm) and llama3.2-3b (tied
embeddings). The JAX package's other registry names raise a ``KeyError``
that says which work brings them.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.llama3_2_3b import CONFIG as _llama3_2_3b
from repro_torch.configs.qwen3_4b import CONFIG as _qwen3_4b
from repro_torch.configs.qwen3_8b import CONFIG as _qwen3_8b
from repro_torch.configs.qwen3_32b import CONFIG as _qwen3_32b
from repro_torch.configs.zamba2_7b import CONFIG as _zamba2
from repro_torch.models.backbone.config import INPUT_SHAPES, ArchConfig, InputShape

REGISTRY: Dict[str, ArchConfig] = {
    c.name: c for c in [_zamba2, _qwen3_4b, _qwen3_8b, _qwen3_32b, _llama3_2_3b]}

ARCH_NAMES = tuple(REGISTRY)

# The JAX package's other configs, and the backbone modules each still needs.
NOT_PORTED = {
    "whisper-base": "the whisper encoder and cross-attention",
    "olmoe-1b-7b": "the MoE block",
    "phi3.5-moe-42b-a6.6b": "the MoE block",
    "qwen2-vl-2b": "M-RoPE and the vision stub",
    "xlstm-1.3b": "the mLSTM/sLSTM blocks",
}


def get_config(name: str) -> ArchConfig:
    if name in REGISTRY:
        return REGISTRY[name]
    if name in NOT_PORTED:
        raise KeyError(f"arch {name!r} is not ported yet: a later slice brings "
                       f"{NOT_PORTED[name]}; ported: {sorted(REGISTRY)}")
    raise KeyError(f"unknown arch {name!r}; available: {sorted(REGISTRY)}")


__all__ = ["ARCH_NAMES", "INPUT_SHAPES", "REGISTRY", "ArchConfig", "InputShape", "get_config"]
