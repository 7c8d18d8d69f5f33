"""granite-8b [dense] — 36L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=49152; llama-arch, code.  [arXiv:2405.04324; hf]  (copy of
``repro/configs/granite_8b.py``)"""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="granite-8b",
    family="dense",
    source="arXiv:2405.04324",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=49152,
    pattern=(LayerSpec(mixer="attn", mlp="dense"),),  # ×36
    tie_embeddings=True,
    rope_theta=10000000.0,
)
