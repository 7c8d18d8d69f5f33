"""llama4-maverick-400b-a17b [moe] — 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048; MoE 128 experts top-1 + shared, interleaved
dense/MoE layers, early-fusion multimodal (stub: model accepts
``inputs_embeds`` with modality tokens pre-embedded).
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

Note: 40 query heads do not divide the 16-way model axis.  The naive
fallback (shard on head_dim) makes XLA all-reduce full O(S²) score tensors —
~6 TB/chip/step at train_4k.  Default is therefore ``attn_head_padding``:
query heads are zero-padded 40→48 group-preservingly (numerically exact,
+20% attention-q FLOPs) so attention shards on heads; measured 12.8× cut of
the collective term (EXPERIMENTS.md §Perf).  Pass --no-pad via a config
override to reproduce the naive baseline.

(Copy of ``repro/configs/llama4_maverick_400b_a17b.py``.)
"""
from repro_torch.configs.base import ArchConfig, LayerSpec, MoEConfig

DENSE = LayerSpec(mixer="attn", mlp="dense")
MOE = LayerSpec(mixer="attn", mlp="moe")

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    pattern=(DENSE, MOE),  # ×24 — interleaved dense / MoE
    moe=MoEConfig(
        n_experts=128, top_k=1, d_ff_expert=8192, n_shared=1,
        capacity_factor=1.25,
    ),
    tie_embeddings=False,
    rope_theta=500000.0,
    attn_head_padding=True,
)
