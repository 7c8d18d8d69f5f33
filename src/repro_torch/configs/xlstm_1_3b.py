"""xlstm-1.3b [ssm] — 48L d_model=2048 4H d_ff=0 vocab=50304; sLSTM + mLSTM
blocks at 7:1 ratio.  [arXiv:2405.04517; unverified]  (copy of
``repro/configs/xlstm_1_3b.py``)

mLSTM blocks carry their own 2× up/down projection (d_ff=0 in the paper's
table means "no separate FFN"); the sLSTM block is followed by a GeGLU FFN of
4/3 ratio (2688 ≈ 4/3·2048, rounded to a TP-16-divisible size) per the xLSTM
block design.  Pure recurrent state → runs the long_500k decode cell.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

M = LayerSpec(mixer="mlstm", mlp="none")
S = LayerSpec(mixer="slstm", mlp="dense")

CONFIG = ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    source="arXiv:2405.04517",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    head_dim=512,
    d_ff=2688,
    vocab_size=50304,
    pattern=(M, M, M, M, M, M, M, S),  # ×6 — 7 mLSTM : 1 sLSTM
    rnn_width=4096,
    conv_width=4,
    act="gelu",
    tie_embeddings=True,
    subquadratic=True,
)
