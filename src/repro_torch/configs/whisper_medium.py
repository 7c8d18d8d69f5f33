"""whisper-medium [audio] — 24L d_model=1024 16H (GQA kv=16) d_ff=4096
vocab=51865; enc-dec with conv frontend STUB (input_specs provides
precomputed frame embeddings).  [arXiv:2212.04356; unverified]
(copy of ``repro/configs/whisper_medium.py``)"""
from repro_torch.configs.base import ArchConfig, EncoderConfig, LayerSpec

CONFIG = ArchConfig(
    name="whisper-medium",
    family="audio",
    source="arXiv:2212.04356",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51865,  # padded to 51968 for TP divisibility
    pattern=(LayerSpec(mixer="attn", mlp="dense", cross_attn=True),),  # ×24 decoder
    encoder=EncoderConfig(n_layers=24, n_frames=1500, d_model=1024, n_heads=16, d_ff=4096),
    act="gelu",
    tie_embeddings=True,
)
