"""mamba2-780m [ssm]: attention-free SSD (state-space duality).

48L d_model=1536 (attn-free) d_ff=0 vocab=50280, ssm_state=128
[arXiv:2405.21060; unverified]. Pure Mamba2 blocks, no MLP (d_ff=0).
"""
from repro_torch.configs.base import MAMBA, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=1,            # unused: attention-free
    n_kv_heads=1,
    head_dim=64,
    d_ff=0,
    vocab_size=50280,
    pattern=(MAMBA,),
    ssm=SSMConfig(d_state=128, expand=2, head_dim=64),
    sub_quadratic=True,
)
