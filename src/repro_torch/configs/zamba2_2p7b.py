"""zamba2-2.7b [hybrid]: Mamba2 blocks + shared-weight attention block.

54L d_model=2560 32H (GQA kv=32) d_ff=10240 vocab=32000, ssm_state=64
[arXiv:2411.15242; hf]. Pattern period 6: five Mamba2 blocks then one
invocation of the single shared attention+MLP block (weights reused across
all 9 invocations, zamba2-style).
"""
from repro_torch.configs.base import MAMBA, SHARED_ATTN, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    pattern=(MAMBA, MAMBA, MAMBA, MAMBA, MAMBA, SHARED_ATTN),
    ssm=SSMConfig(d_state=64, expand=2, head_dim=64),
    rope_theta=10_000.0,
    sub_quadratic=True,   # SSM backbone; attention only at 1/6 of positions
)
