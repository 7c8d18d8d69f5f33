"""stablelm-1.6b [dense] — 24L d_model=2048 32H (GQA kv=32) d_ff=5632
vocab=100352.  [hf:stabilityai/stablelm-2-1_6b; unverified]  (copy of
``repro/configs/stablelm_1_6b.py``)"""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="stablelm-1.6b",
    family="dense",
    source="hf:stabilityai/stablelm-2-1_6b",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=5632,
    vocab_size=100352,
    pattern=(LayerSpec(mixer="attn", mlp="dense"),),  # ×24
    tie_embeddings=False,
    rope_theta=10000.0,
)
