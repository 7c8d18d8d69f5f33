"""Architecture configuration (copy of ``repro/configs/base.py`` without
the dryrun's input-shape cells).

An architecture is an ``ArchConfig`` built from a repeating ``LayerSpec``
*super-block* plus an optional remainder; the port's transformer unrolls
them into one list of layers (``models/transformer.py::layer_specs``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Layer / sub-config specs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LayerSpec:
    """One layer inside a super-block."""

    mixer: str = "attn"  # attn | rglru | mlstm | slstm
    window: Optional[int] = None  # sliding-window size for local attention
    mlp: str = "dense"  # dense | moe | none
    cross_attn: bool = False  # inject cross-attention to ctx embeddings


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    d_ff_expert: int = 2048
    n_shared: int = 0  # shared (always-on) experts
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.0


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    absorb: bool = False  # decode-time weight absorption (perf variant)


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder for enc-dec archs (whisper).  Frontend is a stub: the
    ``input_specs`` supply precomputed frame embeddings."""

    n_layers: int = 24
    n_frames: int = 1500
    d_model: int = 1024
    n_heads: int = 16
    d_ff: int = 4096


@dataclass(frozen=True)
class ArchConfig:
    name: str = "arch"
    family: str = "dense"  # dense | hybrid | ssm | moe | audio | vlm
    source: str = ""  # provenance citation

    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 64
    d_ff: int = 1024
    vocab_size: int = 512

    pattern: Tuple[LayerSpec, ...] = (LayerSpec(),)
    remainder: Tuple[LayerSpec, ...] = ()

    # attention details
    qk_norm: bool = False
    attn_softcap: Optional[float] = None
    logit_softcap: Optional[float] = None
    rope_theta: float = 10000.0
    # zero-pad query heads (group-preserving) up to the TP degree so
    # attention shards on heads instead of head_dim — kills the O(S²)
    # score all-reduces when n_heads doesn't divide the model axis
    # (llama4's 40 heads on TP-16; see EXPERIMENTS.md §Perf)
    attn_head_padding: bool = False

    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None

    # recurrent (rglru / xlstm) dims
    rnn_width: int = 0
    conv_width: int = 4

    encoder: Optional[EncoderConfig] = None

    # cross-attn context (vision patches / audio frames), provided pre-embedded
    ctx_len: int = 0
    ctx_dim: int = 0

    tie_embeddings: bool = True
    mtp: bool = False  # DeepSeek-V3 multi-token-prediction head
    act: str = "silu"
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"

    subquadratic: bool = False  # eligible for long_500k decode
    has_decoder: bool = True  # encoder-only archs would skip decode shapes

    # -- derived ----------------------------------------------------------
    @property
    def n_repeats(self) -> int:
        body = self.n_layers - len(self.remainder)
        assert body % len(self.pattern) == 0, (
            f"{self.name}: {self.n_layers} layers not divisible into "
            f"pattern of {len(self.pattern)} (+{len(self.remainder)} remainder)"
        )
        return body // len(self.pattern)

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up so TP-16 sharding always divides evenly."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Reduced configs for CPU smoke tests
# ---------------------------------------------------------------------------


def make_reduced(cfg: ArchConfig) -> ArchConfig:
    """Shrink a full config to a CPU-runnable config of the same family:
    same pattern structure, tiny dims."""
    moe = None
    if cfg.moe is not None:
        # capacity_factor=4: no token drops at smoke-test scale, so cached
        # decode matches the teacher-forced forward exactly
        moe = dataclasses.replace(
            cfg.moe, n_experts=8, top_k=min(cfg.moe.top_k, 2), d_ff_expert=64,
            n_shared=min(cfg.moe.n_shared, 1), capacity_factor=4.0,
        )
    mla = None
    if cfg.mla is not None:
        mla = dataclasses.replace(
            cfg.mla, q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16,
            qk_rope_dim=8, v_head_dim=16,
        )
    enc = None
    if cfg.encoder is not None:
        enc = dataclasses.replace(
            cfg.encoder, n_layers=2, n_frames=16, d_model=64, n_heads=2, d_ff=128
        )

    # shrink layer count: keep one super-block repeat + remainder
    n_layers = len(cfg.pattern) + len(cfg.remainder)
    # shrink windows so local attention is exercised at tiny seq lens
    pattern = tuple(
        dataclasses.replace(l, window=(4 if l.window else None)) for l in cfg.pattern
    )
    remainder = tuple(
        dataclasses.replace(l, window=(4 if l.window else None)) for l in cfg.remainder
    )
    return cfg.replace(
        n_layers=n_layers,
        d_model=64,
        n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        pattern=pattern,
        remainder=remainder,
        moe=moe,
        mla=mla,
        encoder=enc,
        rnn_width=64 if cfg.rnn_width else 0,
        ctx_len=8 if cfg.ctx_len else 0,
        ctx_dim=32 if cfg.ctx_dim else 0,
        dtype="float32",
    )
