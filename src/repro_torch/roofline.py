"""Analytic model FLOPs and the NVIDIA H100 (SXM) roofline constants.

Counterpart of the JAX package's ``roofline.py``: ``model_flops`` is copied
as is; the constants are the H100's (NVIDIA data sheet, dense rates at the
700 W power limit) where the JAX package has a TPU's. The explorer's
``rel_time`` is a ratio of two times priced with the same constants, so the
serving ladder does not depend on them.
"""
from __future__ import annotations

PEAK_FLOPS = 989e12        # bf16 / fp16 tensor cores, dense
PEAK_INT8_OPS = 1979e12    # int8 tensor cores, dense
HBM_BW = 3.35e12           # bytes/s
LINK_BW = 450e9            # NVLink bytes/s each way, per card


def model_flops(cfg, shape, knobs=None) -> float:
    """Analytic useful FLOPs for one step of a cell (whole cluster).

    Train: 6·N_active·tokens + 3·attention; prefill: 2·N_active·tokens +
    attention; decode: 2·N_active·B + decode attention reads.
    """
    from repro_torch.approx.knobs import PRECISE, keep_groups
    from repro_torch.configs.base import ATTN, LOCAL_ATTN, MAMBA, SHARED_ATTN
    knobs = knobs or PRECISE
    n_total = cfg.param_count()
    n_active = n_total
    if cfg.moe is not None:
        k = knobs.topk_override or cfg.moe.top_k
        expert_p = cfg.moe.n_experts * 3 * cfg.d_model * cfg.d_ff
        active_expert_p = k * 3 * cfg.d_model * cfg.d_ff
        n_active = n_total - cfg.n_layers * (expert_p - active_expert_p)
    # embedding gather is not a matmul; unembed matmul counted separately
    n_active -= cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    keep = keep_groups(cfg.n_groups, knobs.layer_skip)
    layer_frac = len(keep) / cfg.n_groups

    B = shape.global_batch
    if knobs.token_drop and shape.kind == "train":
        B = max(1, int(B * (1.0 - knobs.token_drop)))
    S = shape.seq_len
    if shape.kind == "decode":
        tokens = B
        kv_len = S
    else:
        tokens = B * S
        kv_len = S / 2.0            # causal average

    attn = 0.0
    for kind in cfg.kinds():
        if kind in (ATTN, SHARED_ATTN):
            kv = kv_len
        elif kind == LOCAL_ATTN:
            kv = min(cfg.window, kv_len) if shape.kind == "decode" \
                else min(cfg.window, S) / 2.0 + cfg.window / 2.0
            kv = min(kv, kv_len)
        else:
            continue
        if knobs.kv_keep_stride > 1 and shape.kind != "decode":
            kv = kv / knobs.kv_keep_stride
        attn += 4.0 * kv * cfg.q_dim
    attn *= tokens * layer_frac
    if cfg.family == "encdec" and shape.kind != "decode":
        attn += (cfg.n_encoder_layers * 4.0 * cfg.encoder_seq * cfg.q_dim
                 * B * cfg.encoder_seq)
        attn += cfg.n_layers * 4.0 * cfg.encoder_seq * cfg.q_dim * tokens

    ssd = 0.0
    if cfg.ssm is not None:
        di = cfg.ssm.expand * cfg.d_model
        q = cfg.ssm.chunk if shape.kind != "decode" else 1
        per_tok = 2.0 * q * di + 6.0 * di * cfg.ssm.d_state
        n_mamba = sum(1 for k in cfg.kinds() if k == MAMBA)
        ssd = per_tok * n_mamba * tokens * layer_frac

    matmul = 2.0 * n_active * tokens * layer_frac \
        + 2.0 * cfg.vocab_size * cfg.d_model * tokens  # unembed/logits
    if shape.kind in ("decode", "prefill"):
        return matmul + attn + ssd
    return 3.0 * (matmul + attn + ssd)      # fwd + 2x bwd
