"""gemma3-12b [dense]: 5:1 local:global attention, 128k context.

48L d_model=3840 16H (GQA kv=8) d_ff=15360 vocab=262144
[hf:google/gemma-3-1b-pt; unverified]. head_dim=256 (gemma3 uses q_dim
independent of d_model); sliding window 1024 on local layers.
"""
from repro_torch.configs.base import ATTN, LOCAL_ATTN, ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab_size=262144,
    pattern=(LOCAL_ATTN,) * 5 + (ATTN,),
    window=1024,
    rope_theta=1_000_000.0,
    sub_quadratic=True,   # 5/6 of layers are sliding-window
)
