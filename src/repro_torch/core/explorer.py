"""Offline approximation design-space exploration (paper §3 + Fig. 1): the
serving path of the JAX package's ``core/explorer.py`` (``knob_grid``,
``analytic_quality_loss``, ``analytic_cost``, ``pareto_front``,
``explore``) with the analytic backend, ``decode_kv_share`` (the KV
share of a decode step's bytes, from the dry-run's trace of that step where
the JAX package reads its compiled cell's ``cost_analysis``), and
``admission_cost``, the mesh admission pricing. ``kv_share`` falls back to
the analytic 0.5 when the caller passes none.
"""
from __future__ import annotations

import itertools
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.approx.knobs import ApproxKnobs, PRECISE
from repro_torch.configs.base import ModelConfig
from repro_torch.core.variants import ResourcePressure, Variant, VariantTable


def knob_grid(cfg: ModelConfig, *, serving: bool = False) -> List[ApproxKnobs]:
    """Family-aware candidate enumeration (DESIGN.md §Arch-applicability)."""
    precisions = ["bf16", "int8"]
    drops = [0.0, 0.125, 0.25, 0.5]
    skips = [0.0, 0.25]
    strides = [1]
    topks = [0]
    if any(k in ("attn", "local") for k in cfg.kinds()) and not serving:
        strides = [1, 2, 4]
    if cfg.moe is not None:
        t = cfg.moe.top_k
        topks = [0] + sorted({max(1, t // 2), max(1, 3 * t // 4),
                              max(1, t // 4)})
    syncs = [1, 2, 4] if not serving else [1]
    compresses = ["none", "int8"] if not serving else ["none"]
    # serving-only knob: int8 KV cache (orthogonal to matmul precision)
    kv_quants = [False, True] if serving else [False]
    cands = []
    for p, d, s, st, tk, sy, gc, kvq in itertools.product(
            precisions, drops, skips, strides, topks, syncs, compresses,
            kv_quants):
        if serving and (d or s):      # no token/layer drop for serving jobs
            continue
        if gc != "none" and sy > 1:
            # sync elision already removes the per-step pod reduce that
            # compression would shrink (train/step.grad_reduce_for); the
            # combination executes identically to sync-only, so don't
            # enumerate it as a distinct variant
            continue
        # at most two techniques per variant — the paper's variants perforate
        # one loop / lower one type at a time (Fig. 1 spaces), not the full
        # cross-product; this also keeps top-end quality loss near the
        # measured 2-3% band instead of saturating the 5% cap
        active = sum([p != "bf16", d > 0, s > 0, st > 1, tk > 0, sy > 1,
                      gc != "none", kvq])
        if active > 2:
            continue
        cands.append(ApproxKnobs(matmul_precision=p, token_drop=d,
                                 layer_skip=s, kv_keep_stride=st,
                                 topk_override=tk, sync_period=sy,
                                 grad_compress=gc, kv_quant=kvq))
    # dedupe, precise first
    seen, out = set(), []
    for k in [PRECISE] + cands:
        if k not in seen:
            seen.add(k)
            out.append(k)
    return out


# --------------------------------------------------- analytic evaluation --

# calibrated per-knob quality-loss contributions (fractions), fit from the
# measured smoke-scale sweeps (benchmarks/pareto.py) — see EXPERIMENTS.md.
# fit from benchmarks/pareto.py measured smoke sweeps (results/bench/
# pareto_*.json): drop50 ~= 0.9-1.1%, topk-half ~= 1.0%, int8 <= 0.3%;
# layer_skip kept conservative (toy depth underestimates real-depth loss).
_QUALITY = {
    "int8": 0.003,
    "token_drop": 0.022,       # x drop fraction
    "layer_skip": 0.08,        # x skip fraction
    "kv_stride": 0.008,        # x (1 - 1/stride)
    "topk": 0.022,             # x (1 - k/k0)
    "sync": 0.012,             # x (1 - 1/period)
    "grad_compress": 0.004,    # int8 gradient wire noise, consumed per step
    "kv_quant": 0.003,
}


def analytic_quality_loss(cfg: ModelConfig, k: ApproxKnobs) -> float:
    q = 0.0
    if k.matmul_precision == "int8":
        q += _QUALITY["int8"]
    q += _QUALITY["token_drop"] * k.token_drop
    q += _QUALITY["layer_skip"] * k.layer_skip
    if k.kv_keep_stride > 1:
        q += _QUALITY["kv_stride"] * (1 - 1.0 / k.kv_keep_stride)
    if k.topk_override and cfg.moe is not None:
        q += _QUALITY["topk"] * (1 - k.topk_override / cfg.moe.top_k)
    if k.sync_period > 1:
        q += _QUALITY["sync"] * (1 - 1.0 / k.sync_period)
    if k.grad_compress != "none" and k.sync_period == 1:
        # under sync elision the per-step compressed reduce never runs
        # (train/step.grad_reduce_for), so its noise contributes nothing
        q += _QUALITY["grad_compress"]
    if k.kv_quant:
        q += _QUALITY["kv_quant"]
    return q


def decode_ring_bytes(cfg: ModelConfig, batch: int, max_len: int,
                      itemsize: int) -> int:
    """The bytes one dense decode step reads from the K+V rings: every
    attention layer's full ``(B, W, G, hd)`` rings (a local layer's ``W``
    its window), entries of ``itemsize`` bytes."""
    from repro_torch.configs.base import LOCAL_ATTN, MAMBA
    hd, G = cfg.resolved_head_dim, cfg.n_kv_heads
    ring = 0
    for kind in cfg.kinds():
        if kind == MAMBA:
            continue
        W = min(cfg.window, max_len) if kind == LOCAL_ATTN and cfg.window \
            else max_len
        ring += 2 * batch * W * G * hd * itemsize      # K + V read per step
    return ring


def decode_kv_share(cfg: ModelConfig, batch: int, max_len: int, *,
                    dtype=None, quantized: bool = False) -> float:
    """KV-cache share of one dense decode step's device-memory bytes: the
    ring bytes over the bytes the traced decode step accesses
    (``repro_torch.cost``'s count of the step on ``meta`` tensors: every
    op's inputs and outputs, the kernels' own work), where the JAX package
    divides by its compiled cell's ``cost_analysis`` bytes.

    The ring bytes are exact (``decode_ring_bytes``). The paged engines price
    their decode memory term by ``kv_share * occupancy``: the paged kernel
    streams live pages instead of the rings. Parameters and caches are at
    ``dtype`` (fp32 when None), as the numerator's; 0.5 when either count
    is empty, at most 0.95."""
    import torch

    from repro_torch import cost
    from repro_torch.models import api
    from repro_torch.models import lm as lm_mod
    from repro_torch.train import step as step_mod
    dtype = dtype or torch.float32
    step = step_mod.make_serve_step(cfg, PRECISE)
    params = api.abstract(cfg, dtype)
    caches = lm_mod.init_caches(cfg, batch, max_len, dtype=dtype,
                                quantized=quantized, device="meta")
    toks = torch.empty((batch, 1), dtype=torch.int32, device="meta")
    pos = torch.empty((batch,), dtype=torch.int32, device="meta")
    with torch.no_grad(), cost.CountingMode() as mode:
        step(params, toks, pos, caches)
    total = mode.bytes_accessed
    itemsize = 1 if quantized else torch.empty((), dtype=dtype).element_size()
    ring = decode_ring_bytes(cfg, batch, max_len, itemsize)
    if total <= 0 or ring <= 0:
        return 0.5                           # analytic fallback
    return min(ring / total, 0.95)


def analytic_cost(cfg: ModelConfig, shape, k: ApproxKnobs,
                  baseline_art: Optional[dict] = None, *,
                  page_occupancy: Optional[float] = None,
                  kv_share: Optional[float] = None
                  ) -> Tuple[float, ResourcePressure]:
    """(rel_time, pressure) from the roofline model.

    If a dry-run artifact for the precise variant is given, its three terms
    anchor the baseline; knob deltas scale each term analytically.

    ``page_occupancy`` (paged serving engines): fraction of the dense cache
    footprint that is live pages. Dense decode streams the full ``max_len``
    rings every step; a paged pool (fused kernel) streams only mapped pages,
    so the KV share of the decode memory term scales by occupancy — the
    frontier then sees paged memory savings exactly like any other
    memory-side knob. ``kv_share`` is that KV share of decode HBM bytes,
    ideally from ``decode_kv_share`` (the traced decode step's bytes);
    None falls back to the coarse 0.5 heuristic.
    """
    from repro_torch import roofline
    if baseline_art is not None:
        comp = baseline_art["compute_s"]
        mem = baseline_art["memory_s"]
        coll = baseline_art["collective_s"]
    else:
        mf = roofline.model_flops(cfg, shape, PRECISE)
        comp = mf / 256 / roofline.PEAK_FLOPS
        # decode streams every weight + the KV rings per emitted token at
        # trivial arithmetic intensity: firmly HBM-bound, so memory-side knobs
        # (int8 weights, kv_quant) keep paying off after compute knobs bind
        mem = comp * (4.0 if shape.kind == "decode" else 1.2)
        coll = comp * 0.3
    # knob effects on each term
    f_tok = 1.0 - k.token_drop
    f_layer = 1.0 - 0.9 * k.layer_skip
    f_flops = f_tok * f_layer
    f_mem = f_tok * f_layer
    f_coll = f_tok * f_layer
    if k.matmul_precision == "int8":
        f_flops *= 0.70          # int8 MXU ~2x on the matmul share of a step
        f_mem *= 0.55            # weight/activation streaming halves
    if k.kv_keep_stride > 1:
        attn_share = 0.3
        f_flops *= (1 - attn_share) + attn_share / k.kv_keep_stride
        f_mem *= (1 - attn_share) + attn_share / k.kv_keep_stride
    if k.topk_override and cfg.moe is not None:
        moe_share = 0.6
        r = k.topk_override / cfg.moe.top_k
        f_flops *= (1 - moe_share) + moe_share * r
        f_coll *= (1 - moe_share) + moe_share * r
    if k.sync_period > 1:
        # the periodic pod sync is always full-precision (train/step.pod_sync
        # never re-rounds parameters), so compression contributes nothing here
        f_coll *= 1.0 / k.sync_period
    elif k.grad_compress == "int8":
        f_coll *= 0.3
    if k.kv_quant:
        f_mem *= 0.7
    if page_occupancy is not None and shape.kind == "decode":
        # decode HBM traffic priced by LIVE pages (the fused paged kernel
        # streams mapped pages, not slots x max_len rings): scale the KV
        # share of the memory term by occupancy. kv_share comes from the
        # compiled cell's cost_analysis (decode_kv_share) when the caller
        # provides it; 0.5 is the coarse long-context fallback.
        share = 0.5 if kv_share is None else min(max(kv_share, 0.0), 0.95)
        occ = min(max(page_occupancy, 0.0), 1.0)
        f_mem *= (1 - share) + share * occ
    comp2, mem2, coll2 = comp * f_flops, mem * f_mem, coll * f_coll
    t_prec = max(comp, mem, coll)
    t = max(comp2, mem2, coll2)
    # Pressure = per-step traffic normalized by the PRECISE bound: this is
    # the paper's mechanism — approximate variants issue less traffic into
    # the shared resource, so contention drops even while the job runs.
    pressure = ResourcePressure(
        hbm=mem2 / max(t_prec, 1e-30), ici=coll2 / max(t_prec, 1e-30),
        flops=comp2 / max(t_prec, 1e-30))
    return t / max(t_prec, 1e-30), pressure


# ------------------------------------------------------- pareto pruning --

def admission_cost(cfg: ModelConfig, mesh, chunk_len: int, kv_len: int, *,
                   use_kernel: Optional[bool] = None,
                   kv_quant: bool = False) -> dict:
    """Per-device price of one admission chunk's attention, laid out as the
    chunk cell runs it: the ring layout from ``dist.sharding.prefill_plan``
    (the function the serving engine dispatches on), priced by
    ``roofline.admission_terms``. ``use_kernel`` None means "a CUDA device
    is present" (the ring's kernel runs there). Returns the terms plus
    ``n_shards`` and the plan's or the fallback's ``reason`` ("" = ring
    dispatched)."""
    import torch

    from repro_torch import roofline
    from repro_torch.dist.sharding import prefill_plan
    n, reason = 1, "no mesh (single device)"
    if mesh is not None:
        if use_kernel is None:
            use_kernel = torch.cuda.is_available()
        if not use_kernel:
            reason = "kernel off: no CUDA device"
        else:
            plan, reason = prefill_plan(cfg, mesh, chunk_len)
            if plan is not None:
                n = plan.n_shards
    out = roofline.admission_terms(cfg, chunk_len, kv_len, n_shards=n,
                                   kv_quant=kv_quant)
    out["n_shards"] = n
    out["reason"] = reason
    return out


def pareto_front(points: Sequence[Tuple[float, float]]) -> List[int]:
    """Indices of non-dominated (quality_loss, rel_time) points, sorted by
    increasing quality loss. Lower is better on both axes."""
    order = sorted(range(len(points)), key=lambda i: (points[i][0],
                                                      points[i][1]))
    out, best_t = [], float("inf")
    for i in order:
        if points[i][1] < best_t - 1e-12:
            out.append(i)
            best_t = points[i][1]
    return out


def explore(cfg: ModelConfig, shape, *, serving: bool = False,
            max_loss: float = 0.05, baseline_art: Optional[dict] = None,
            evaluate: Optional[Callable] = None,
            max_variants: int = 8,
            page_occupancy: Optional[float] = None,
            kv_share: Optional[float] = None) -> VariantTable:
    """Build the ordered VariantTable for one (arch, shape) colocation.

    ``evaluate(knobs) -> (rel_time, quality_loss, pressure)`` overrides the
    analytic backend (the measured path used by benchmarks).
    ``page_occupancy`` prices decode HBM by live pages (paged engines);
    ``kv_share`` anchors that pricing on the compiled decode cell's
    cost_analysis bytes (``decode_kv_share``).
    """
    cands = knob_grid(cfg, serving=serving)
    evaluated = []
    for k in cands:
        if evaluate is not None:
            rel_t, qloss, pressure = evaluate(k)
        else:
            rel_t, pressure = analytic_cost(cfg, shape, k, baseline_art,
                                            page_occupancy=page_occupancy,
                                            kv_share=kv_share)
            qloss = analytic_quality_loss(cfg, k)
        evaluated.append(Variant(k, rel_t, qloss, pressure))
    # threshold first (paper: discard variants with inaccuracy > 5%)
    ok = [v for v in evaluated if v.quality_loss <= max_loss]
    pts = [(v.quality_loss, v.rel_time) for v in ok]
    front = [ok[i] for i in pareto_front(pts)]
    # ordered precise -> most approximate (increasing quality loss)
    front.sort(key=lambda v: v.quality_loss)
    if not front or not front[0].knobs.is_precise():
        precise = next(v for v in evaluated if v.knobs.is_precise())
        front = [precise] + [v for v in front if not v.knobs.is_precise()]
    if len(front) > max_variants:
        idx = np.linspace(0, len(front) - 1, max_variants).round().astype(int)
        front = [front[int(i)] for i in sorted(set(idx))]
    return VariantTable(front)
