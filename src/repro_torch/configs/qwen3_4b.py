"""qwen3-4b [dense] — 36L d_model=2560 32H (GQA kv=8) d_ff=9728
vocab=151936; qk_norm.  [hf:Qwen/Qwen3-8B; hf]  (copy of
``repro/configs/qwen3_4b.py``)"""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="qwen3-4b",
    family="dense",
    source="hf:Qwen/Qwen3-8B",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab_size=151936,
    pattern=(LayerSpec(mixer="attn", mlp="dense"),),  # ×36
    qk_norm=True,
    tie_embeddings=True,
    rope_theta=1000000.0,
)
