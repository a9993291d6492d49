"""paligemma-3b [vlm]: SigLIP stub + gemma backbone (MQA).

18L d_model=2048 8H (GQA kv=1) d_ff=16384 vocab=257216 [arXiv:2407.07726; hf].
head_dim=256 (gemma-2b convention). The SigLIP tower is a stub:
``input_specs()`` provides 256 precomputed patch embeddings prepended to the
text sequence.
"""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    pattern=(ATTN,),
    n_prefix_tokens=256,
    rope_theta=10_000.0,
    sub_quadratic=False,
)
