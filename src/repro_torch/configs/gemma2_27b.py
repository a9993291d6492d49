"""gemma2-27b [dense]: local+global alternating attention, logit softcaps.

46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000
[arXiv:2408.00118; hf]. head_dim=128 (q_dim 4096 != d_model), window 4096,
attn softcap 50.0, final logit softcap 30.0.
"""
from repro_torch.configs.base import ATTN, LOCAL_ATTN, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    pattern=(LOCAL_ATTN, ATTN),
    window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    rope_theta=10_000.0,
    sub_quadratic=True,   # alternating sliding-window layers
)
