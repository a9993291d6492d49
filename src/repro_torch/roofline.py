"""Analytic model FLOPs, admission and decode terms, and the NVIDIA H100
(SXM) roofline constants.

Counterpart of the JAX package's ``roofline.py``: ``model_flops``,
``admission_terms`` and ``decode_min_bytes`` are copied as they are; the
constants are the H100's (NVIDIA data sheet, dense rates at the 700 W
power limit) where the JAX package has a TPU's, so the seconds differ
while the FLOP and byte terms agree. The explorer's ``rel_time`` is a
ratio of two times priced with the same constants, so the serving ladder
does not depend on them. The dry-run's HLO accounting
(``collective_bytes`` and the compiled terms) waits with the dry-run.
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


def admission_terms(cfg, chunk_len: int, kv_len: int, *, n_shards: int = 1,
                    kv_quant: bool = False):
    """Per-device roofline terms of one admission chunk's attention: the
    ring's per-shard cost model (``kernels.ring_attention``) summed over
    the config's attention layers (a local layer sees at most its window
    plus the chunk), priced at the H100's rates. ``n_shards`` is the ring
    plan's shard count (1 = unsharded). Returns ``flops_per_device``,
    ``hbm_bytes_per_device``, ``compute_s`` and ``memory_s``."""
    from repro_torch.configs.base import ATTN, LOCAL_ATTN, SHARED_ATTN
    from repro_torch.kernels.ring_attention import (
        sharded_prefill_attn_flops, sharded_prefill_hbm_bytes)
    hd = cfg.resolved_head_dim
    kv_bytes = 1 if kv_quant else 4
    flops = bytes_ = 0.0
    for kind in cfg.kinds():
        if kind in (ATTN, SHARED_ATTN):
            kv = kv_len
        elif kind == LOCAL_ATTN:
            kv = min(cfg.window + chunk_len, kv_len)
        else:
            continue
        flops += sharded_prefill_attn_flops(chunk_len, kv, cfg.n_heads, hd,
                                            n_shards=n_shards)
        bytes_ += sharded_prefill_hbm_bytes(chunk_len, kv, cfg.n_kv_heads,
                                            hd, n_shards=n_shards,
                                            n_heads=cfg.n_heads,
                                            kv_bytes=kv_bytes)
    return {"flops_per_device": flops, "hbm_bytes_per_device": bytes_,
            "compute_s": flops / PEAK_FLOPS, "memory_s": bytes_ / HBM_BW}


def decode_min_bytes(cfg, shape, n_chips: int, kv_quant: bool = False):
    """A lower bound on each card's decode traffic a token step: the
    weights (bf16) and the KV/SSM state read once."""
    from repro_torch.configs.base import ATTN, LOCAL_ATTN, MAMBA, SHARED_ATTN
    params_b = cfg.param_count() * 2.0
    kv_bytes = 1 if kv_quant else 2
    cache_b = 0.0
    for kind in cfg.kinds():
        if kind in (ATTN, SHARED_ATTN):
            cache_b += 2 * cfg.kv_dim * kv_bytes * shape.seq_len
        elif kind == LOCAL_ATTN:
            cache_b += 2 * cfg.kv_dim * kv_bytes * min(cfg.window,
                                                       shape.seq_len)
        elif kind == MAMBA and cfg.ssm is not None:
            di = cfg.ssm.expand * cfg.d_model
            nh = di // cfg.ssm.head_dim
            cache_b += nh * cfg.ssm.head_dim * cfg.ssm.d_state * 4
    cache_b *= shape.global_batch
    return (params_b + cache_b) / n_chips
