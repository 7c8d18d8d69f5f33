"""deepseek-v3-671b [moe] — 61L d_model=7168 128H d_ff(expert)=2048
vocab=129280; MLA, MoE 1 shared + 256 routed top-8, MTP.
[arXiv:2412.19437; hf]

58 (MLA + MoE) layers scanned + 3 dense layers (d_ff=18432) as the unrolled
remainder (the real model places the dense layers first; the scan-friendly
layout places them last — structurally/roofline equivalent, noted in
DESIGN.md).  MTP is a lightweight extra prediction head (norm+proj+shared
embedding) rather than the full extra block, flagged via ``mtp=True``.

(Copy of ``repro/configs/deepseek_v3_671b.py``.)
"""
from repro_torch.configs.base import ArchConfig, LayerSpec, MLAConfig, MoEConfig

MOE_LAYER = LayerSpec(mixer="attn", mlp="moe")
DENSE_LAYER = LayerSpec(mixer="attn", mlp="dense")

CONFIG = ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    source="arXiv:2412.19437",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    head_dim=128,
    d_ff=18432,  # dense-layer FFN width
    vocab_size=129280,
    pattern=(MOE_LAYER,),  # ×58
    remainder=(DENSE_LAYER, DENSE_LAYER, DENSE_LAYER),
    mla=MLAConfig(
        q_lora_rank=1536, kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        n_experts=256, top_k=8, d_ff_expert=2048, n_shared=1,
        capacity_factor=1.25,
    ),
    mtp=True,
    tie_embeddings=False,
    rope_theta=10000.0,
)
