"""recurrentgemma-9b [hybrid] — 38L d_model=4096 16H (GQA kv=1) d_ff=12288
vocab=256000; RG-LRU + local attention, 1 attn : 2 recurrent.
[arXiv:2402.19427; unverified]  (copy of ``repro/configs/recurrentgemma_9b.py``)

Pattern: (rglru, rglru, local-attn) × 12 super-blocks + 2 trailing recurrent
layers = 38.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

REC = LayerSpec(mixer="rglru", mlp="dense")
ATT = LayerSpec(mixer="attn", window=2048, mlp="dense")

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    source="arXiv:2402.19427",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    pattern=(REC, REC, ATT),  # ×12
    remainder=(REC, REC),
    rnn_width=4096,
    conv_width=4,
    act="gelu",
    tie_embeddings=True,
    subquadratic=True,
)
