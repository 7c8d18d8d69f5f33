"""Analytic parameter counts (total and per-token active) per ArchConfig —
used for MODEL_FLOPS = 6·N_active·D in the roofline analysis.  A copy of
``repro/analysis/params.py`` over the port's ``ArchConfig``: the same
functions, names and integers."""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig, LayerSpec


def _attn_params(cfg: ArchConfig) -> int:
    if cfg.mla:
        m = cfg.mla
        qk = m.qk_nope_dim + m.qk_rope_dim
        return (
            cfg.d_model * m.q_lora_rank
            + m.q_lora_rank * cfg.n_heads * qk
            + cfg.d_model * (m.kv_lora_rank + m.qk_rope_dim)
            + m.kv_lora_rank * cfg.n_heads * (m.qk_nope_dim + m.v_head_dim)
            + cfg.n_heads * m.v_head_dim * cfg.d_model
        )
    return cfg.d_model * cfg.head_dim * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)


def _mlp_params(cfg: ArchConfig) -> int:
    return 3 * cfg.d_model * cfg.d_ff


def _moe_params(cfg: ArchConfig, active: bool) -> int:
    m = cfg.moe
    per_expert = 3 * cfg.d_model * m.d_ff_expert
    routed = (m.top_k if active else m.n_experts) * per_expert
    shared = m.n_shared * per_expert
    return routed + shared + cfg.d_model * m.n_experts


def _rglru_params(cfg: ArchConfig) -> int:
    r = cfg.rnn_width or cfg.d_model
    return 3 * cfg.d_model * r + 2 * r * r + cfg.conv_width * r


def _mlstm_params(cfg: ArchConfig) -> int:
    r = cfg.rnn_width or 2 * cfg.d_model
    dh = r // cfg.n_heads
    return 3 * cfg.d_model * r + 3 * r * dh + cfg.conv_width * r


def _slstm_params(cfg: ArchConfig) -> int:
    r = cfg.d_model
    nh = cfg.n_heads
    dh = r // nh
    return 4 * cfg.d_model * r + nh * 4 * dh * dh + r * cfg.d_model


def _layer_params(cfg: ArchConfig, spec: LayerSpec, active: bool) -> int:
    n = 0
    if spec.mixer == "attn":
        n += _attn_params(cfg)
    elif spec.mixer == "rglru":
        n += _rglru_params(cfg)
    elif spec.mixer == "mlstm":
        n += _mlstm_params(cfg)
    elif spec.mixer == "slstm":
        n += _slstm_params(cfg)
    if spec.cross_attn:
        n += _attn_params(cfg)
    if spec.mlp == "dense":
        n += _mlp_params(cfg)
    elif spec.mlp == "moe":
        n += _moe_params(cfg, active)
    return n


def _count(cfg: ArchConfig, active: bool) -> int:
    n = cfg.padded_vocab * cfg.d_model  # embedding
    if not cfg.tie_embeddings:
        n += cfg.d_model * cfg.padded_vocab
    for spec in cfg.pattern:
        n += _layer_params(cfg, spec, active) * cfg.n_repeats
    for spec in cfg.remainder:
        n += _layer_params(cfg, spec, active)
    if cfg.encoder is not None:
        e = cfg.encoder
        n += e.n_layers * (4 * e.d_model * e.d_model + 3 * e.d_model * e.d_ff)
    if cfg.ctx_dim:
        n += cfg.ctx_dim * cfg.d_model
    return n


def total_params(cfg: ArchConfig) -> int:
    return _count(cfg, active=False)


def active_params(cfg: ArchConfig) -> int:
    """Params touched per token (MoE: top_k + shared experts only)."""
    return _count(cfg, active=True)


def kv_cache_bytes(cfg: ArchConfig, batch: int, seq: int) -> int:
    """Decode-state bytes for the whole model (bf16 KV / fp32 recurrent)."""
    total = 0
    specs = list(cfg.pattern) * cfg.n_repeats + list(cfg.remainder)
    for spec in specs:
        if spec.mixer == "attn":
            if cfg.mla:
                per_tok = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_dim
                total += batch * seq * per_tok * 2
            else:
                length = min(seq, spec.window) if spec.window else seq
                total += batch * length * cfg.n_kv_heads * cfg.head_dim * 2 * 2
        elif spec.mixer == "rglru":
            r = cfg.rnn_width or cfg.d_model
            total += batch * r * 4 + batch * (cfg.conv_width - 1) * r * 2
        elif spec.mixer == "mlstm":
            r = cfg.rnn_width or 2 * cfg.d_model
            dh = r // cfg.n_heads
            total += batch * cfg.n_heads * (dh * dh + dh + 1) * 4
        elif spec.mixer == "slstm":
            total += 4 * batch * cfg.d_model * 4
    return total


def min_bytes_estimate(cfg: ArchConfig, shape, opt_state_bytes_per_param: float = 8.0) -> float:
    """Analytic HBM-traffic floor per step (whole model, all chips):

    * decode — read the active weights once + the full decode state once;
    * prefill — read weights once + write the cache once;
    * train — weights fwd+bwd reads, param read+write, opt-state read+write,
      gradient write, plus one activation save/restore per layer.

    Used as the denominator for the memory roofline fraction.
    """
    p_total = total_params(cfg) * 2  # bf16 resident weights
    p_active = active_params(cfg) * 2
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return p_active + kv_cache_bytes(cfg, b, s)
    act = b * s * cfg.d_model * 2 * cfg.n_layers  # one saved tensor per layer
    if shape.kind == "prefill":
        return p_active * max(1, 1) + kv_cache_bytes(cfg, b, s) + act
    # train: 2 weight passes + param rw + state rw + grad write (+acts rw)
    state = total_params(cfg) * opt_state_bytes_per_param
    return 2 * p_active + 2 * p_total + 2 * state + p_total + 2 * act
