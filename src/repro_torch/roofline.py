"""The three-term roofline of a dry-run cell, analytic model FLOPs,
admission and decode terms, and the NVIDIA H100 (SXM) roofline constants.

Counterpart of the JAX package's ``roofline.py``: ``model_flops``,
``admission_terms``, ``decode_min_bytes``, ``RooflineTerms`` and
``terms_from_artifact`` are copied as they are; the constants are the
H100's (NVIDIA data sheet, dense rates at the 700 W power limit) where the
JAX package has a TPU's, so the seconds differ while the FLOP and byte
terms agree. The explorer's ``rel_time`` is a ratio of two times priced
with the same constants, so the serving ladder does not depend on them.

    compute term    = FLOPs / the peak of the cell's compute dtype
    memory term     = bytes accessed / HBM_BW
    collective term = wire bytes / LINK_BW

all of one position's program (``launch/dryrun.py`` traces one), so no
division by the position count. ``collective_bytes`` takes the trace's
collective records (``repro_torch.cost``) where the JAX package parses
HLO text, and applies the JAX package's ring coefficients unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable

PEAK_FLOPS = 989e12        # bf16 / fp16 tensor cores, dense
PEAK_FP32_FLOPS = 67e12    # fp32 on the CUDA cores
PEAK_INT8_OPS = 1979e12    # int8 tensor cores, dense
HBM_BW = 3.35e12           # bytes/s
LINK_BW = 450e9            # NVLink bytes/s each way, per card

# ring-model wire bytes per device, as a multiple of the payload (the JAX
# package's ``_WIRE_COEF``)
_WIRE_COEF = {
    "all-gather": 1.0,        # receives the full result
    "all-reduce": 2.0,        # reduce-scatter + all-gather
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "ragged-all-to-all": 1.0,
    "collective-permute": 1.0,
}


def peak_flops(compute: str) -> float:
    """The peak of a cell's compute dtype: "bf16", "fp32" or "int8"."""
    return {"bf16": PEAK_FLOPS, "fp32": PEAK_FP32_FLOPS,
            "int8": PEAK_INT8_OPS}[compute]


def collective_bytes(records: Iterable) -> Dict[str, float]:
    """Wire bytes a position sends, by collective kind, from the trace's
    collective records (``cost.CollectiveRecord``: ``kind`` and
    ``payload``, the payload as the JAX package's HLO parser takes it:
    the larger of result and operands), each times its ring
    coefficient."""
    out: Dict[str, float] = {}
    for r in records:
        out[r.kind] = out.get(r.kind, 0.0) + _WIRE_COEF[r.kind] * r.payload
    return out


@dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops_per_chip: float
    hlo_flops: float
    peak: float = PEAK_FLOPS

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        """Model FLOPs / counted FLOPs: the remat and redundancy waste."""
        return self.model_flops_per_chip / max(self.hlo_flops, 1.0)

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute time / bound time: the score."""
        useful_s = self.model_flops_per_chip / self.peak
        return useful_s / max(self.bound_s, 1e-30)


def terms_from_artifact(art: dict, model_flops_total: float,
                        n_chips: int, compute: str = "bf16"
                        ) -> RooflineTerms:
    """The terms of a dry-run artifact (either package's), the compute
    term at ``compute``'s peak."""
    peak = peak_flops(compute)
    wire = sum(art.get("collectives", {}).values())
    return RooflineTerms(
        compute_s=art["flops"] / peak,
        memory_s=art["bytes_accessed"] / HBM_BW,
        collective_s=wire / LINK_BW,
        model_flops_per_chip=model_flops_total / n_chips,
        hlo_flops=art["flops"],
        peak=peak,
    )


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
