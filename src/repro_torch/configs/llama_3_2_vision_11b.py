"""llama-3.2-vision-11b [vlm] — 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256; cross-attention image layers every 5th layer.  The vision
tower is a STUB: ``input_specs`` provides precomputed patch embeddings
(B, 1600, 7680) which the model projects to d_model.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]
(copy of ``repro/configs/llama_3_2_vision_11b.py``)"""
from repro_torch.configs.base import ArchConfig, LayerSpec

SELF = LayerSpec(mixer="attn", mlp="dense")
XATT = LayerSpec(mixer="attn", mlp="dense", cross_attn=True)

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    source="hf:meta-llama/Llama-3.2-11B-Vision",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    pattern=(XATT, SELF, SELF, SELF, SELF),  # ×8 — cross-attn every 5th
    ctx_len=1600,
    ctx_dim=7680,
    tie_embeddings=False,
    rope_theta=500000.0,
)
