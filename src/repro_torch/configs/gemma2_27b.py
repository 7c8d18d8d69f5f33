"""gemma2-27b [dense] — 46L d_model=4608 32H (GQA kv=16) d_ff=36864
vocab=256000; local+global alternating attention, logit softcapping.
[arXiv:2408.00118; hf]  (copy of ``repro/configs/gemma2_27b.py``)"""
from repro_torch.configs.base import ArchConfig, LayerSpec

LOCAL = LayerSpec(mixer="attn", window=4096, mlp="dense")
GLOBAL = LayerSpec(mixer="attn", window=None, mlp="dense")

CONFIG = ArchConfig(
    name="gemma2-27b",
    family="dense",
    source="arXiv:2408.00118",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    pattern=(LOCAL, GLOBAL),  # ×23
    attn_softcap=50.0,
    logit_softcap=30.0,
    act="gelu",
    tie_embeddings=True,
    rope_theta=10000.0,
)
