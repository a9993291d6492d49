"""whisper-large-v3 [audio]: encoder-decoder backbone; conv frontend is a stub.

32L d_model=1280 20H (GQA kv=20 = MHA) d_ff=5120 vocab=51866
[arXiv:2212.04356; unverified]. The modality frontend is a stub:
``input_specs()`` provides precomputed 1500-frame embeddings. Assigned shapes
apply to the decoder sequence (DESIGN.md §5). Adaptation note: MLPs are SwiGLU
(framework-uniform) rather than whisper's 2-matrix GELU.
"""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="encdec",
    n_layers=32,             # decoder layers
    n_encoder_layers=32,
    encoder_seq=1500,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    pattern=(ATTN,),
    rope_theta=10_000.0,
    sub_quadratic=False,
)
