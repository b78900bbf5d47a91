"""Architecture configuration of the backbone (a copy of ``repro``'s).

One ``ArchConfig`` per architecture (``repro_torch/configs/``);
``reduced()`` derives the CPU smoke variant (≤2 layers, d_model ≤ 128,
f32) from the same family. The fields and defaults are the JAX
package's, with one deliberate difference: there is no ``use_pallas``.
On the card the port has one path, the hand-written kernels; on the CPU
the kernel wrappers take their plain versions.

``analysis_mode`` and the ``PerfConfig`` levers serve the TPU mesh and
roofline analysis; the port's blocks raise ``NotImplementedError`` when
any is set (:func:`check_port_supported`).
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Optional, Tuple

ArchType = Literal["dense", "moe", "ssm", "hybrid", "audio", "vlm"]
BlockKind = Literal["attn", "mamba2", "mlstm", "slstm"]


@dataclasses.dataclass(frozen=True)
class BayesConfig:
    """SFVI latent decomposition: Z_G a rank-r LM-head adapter (+ ω_G),
    Z_Lj a rank-r_l head adapter + logit bias per silo."""

    global_rank: int = 8
    local_rank: int = 2
    local_bias: bool = True

    def global_dim(self, d_model: int, vocab: int) -> int:
        return self.global_rank * (d_model + vocab)

    def local_dim(self, d_model: int, vocab: int) -> int:
        d = self.local_rank * (d_model + vocab)
        if self.local_bias:
            d += vocab
        return d


@dataclasses.dataclass(frozen=True)
class PerfConfig:
    """The JAX package's TPU performance levers; all off by default. The
    port implements none of them yet."""

    masked_nll: bool = False
    pad_vocab: bool = False
    zero_opt: bool = False
    act_shard: bool = False
    microbatch: int = 0
    pad_heads: int = 0

    @property
    def any(self) -> bool:
        return any((self.masked_nll, self.pad_vocab, self.zero_opt,
                    self.act_shard, self.microbatch > 1, self.pad_heads > 0))


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: ArchType
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // num_heads

    # attention details
    qk_norm: bool = False
    rope_theta: float = 1e4
    mrope: bool = False  # Qwen2-VL multimodal RoPE
    sliding_window: Optional[int] = None

    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    d_expert: int = 0
    capacity_factor: float = 1.25

    # SSM (mamba2)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64

    # hybrid (zamba2): every hybrid_attn_period-th block is attention
    hybrid_attn_period: int = 0
    shared_attn: bool = False  # zamba2: ONE attention block's weights reused
    # xLSTM: sLSTM block period; others are mLSTM
    slstm_period: int = 0

    # enc-dec (whisper)
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_seq_len: int = 1500

    # VLM stub frontend
    num_vision_tokens: int = 0

    # training details
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"

    # SFVI
    bayes: BayesConfig = dataclasses.field(default_factory=BayesConfig)

    # Roofline-analysis mode of the JAX package (not ported: raises)
    analysis_mode: bool = False

    # Performance levers (all off = paper-faithful baseline; not ported)
    perf: PerfConfig = dataclasses.field(default_factory=PerfConfig)

    source: str = ""  # paper/model-card citation

    # ------------------------------------------------------------------

    @property
    def head_dim_(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def block_kind(self, layer_idx: int) -> BlockKind:
        """Which block family does layer ``layer_idx`` use?"""
        if self.arch_type == "hybrid" and self.hybrid_attn_period:
            period = self.hybrid_attn_period
            return "attn" if (layer_idx % period) == (period - 1) else "mamba2"
        if self.arch_type == "ssm" and self.slstm_period:
            period = self.slstm_period
            return "slstm" if (layer_idx % period) == (period - 1) else "mlstm"
        if self.arch_type == "ssm":
            return "mlstm"
        return "attn"

    @property
    def block_pattern(self) -> Tuple[BlockKind, ...]:
        """The block kind of every layer, in order."""
        return tuple(self.block_kind(i) for i in range(self.num_layers))

    def reduced(self) -> ArchConfig:
        """CPU smoke-test variant of the same family."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=2,
            d_model=min(self.d_model, 128),
            num_heads=4,
            num_kv_heads=min(max(1, self.num_kv_heads * 4 // self.num_heads), 4),
            head_dim=32,
            d_ff=min(self.d_ff, 256) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            num_experts_per_tok=min(self.num_experts_per_tok, 2) if self.num_experts_per_tok else 0,
            d_expert=min(self.d_expert, 64) if self.d_expert else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_state else 64,
            sliding_window=min(self.sliding_window, 128) if self.sliding_window else None,
            hybrid_attn_period=min(self.hybrid_attn_period, 2) if self.hybrid_attn_period else 0,
            slstm_period=2 if self.slstm_period else 0,
            num_encoder_layers=min(self.num_encoder_layers, 2),
            encoder_seq_len=min(self.encoder_seq_len, 64),
            num_vision_tokens=min(self.num_vision_tokens, 16) if self.num_vision_tokens else 0,
            dtype="float32",
            bayes=BayesConfig(global_rank=2, local_rank=1),
        )


def check_port_supported(cfg: ArchConfig) -> None:
    """Raise for the JAX package's TPU-only modes, which the port lacks."""
    if cfg.analysis_mode:
        raise NotImplementedError(
            "analysis_mode (the TPU roofline's unrolled analysis) is not ported")
    if cfg.perf.any:
        raise NotImplementedError(
            f"PerfConfig levers are not ported yet: {cfg.perf}")


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}
