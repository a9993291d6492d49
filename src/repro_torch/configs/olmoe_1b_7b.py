"""olmoe-1b-7b [moe]: 64 experts, top-8.

16L d_model=2048 16H (GQA kv=16 = MHA) d_ff=1024 (per expert) vocab=50304,
MoE 64e top-8 [arXiv:2409.02060; hf]. The port prices it (explorer,
colocation simulator) but builds no model of it until MoE is ported.
"""
from repro_torch.configs.base import ATTN, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1024,
    vocab_size=50304,
    pattern=(ATTN,),
    moe=MoEConfig(n_experts=64, top_k=8),
    rope_theta=10_000.0,
    sub_quadratic=False,
)
