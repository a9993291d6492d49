"""Top-k MoE layer with sort-based dispatch and expert parallelism.
Counterpart of the JAX package's ``models/moe.py``.

Dispatch is index-based (a stable sort by expert, capacity-bounded slots),
never a one-hot dispatch tensor. Every op is a device op on shapes fixed
by the token count: no ``.item()``, ``nonzero``, boolean-mask indexing or
``bincount`` (which reads its maximum back to the host), so a decode step
that routes can be captured in a CUDA graph. The experts' products are
batched over the experts: on the int8 rungs each of the three is one
``quantize_rows`` and one ``int8_matmul`` launch for all experts
(``ops.quantized_matmul`` on a stack), the counterpart of the JAX
package's ``jax.vmap`` of the Pallas call; on precise they are ``torch.bmm``,
as the JAX package leaves its ``einsum`` to XLA.

Expert parallelism (``ep_axis`` and ``mesh``) runs the JAX package's
fully manual ``shard_map`` region per position of the port's mesh (every
position is the one card): the tokens split over every mesh axis (over
``ep_axis`` alone for decode-size batches, else replicated), each position
routes its own tokens with its own capacity (``_capacity`` of its token
count, so the capacity-drop set is expert parallelism's, not the local
one's), the ``all_to_all`` hands expert shard j (position j along
``ep_axis``) its E/m experts' rows from every position of its group, each
shard runs its experts' products (on an int8 rung one ``int8_matmul``
launch a shard a product, its E/m experts on the grid), the exchange goes
back and each position combines its tokens. The exchanges are recorded
in ``dist.collectives.WIRE``. The JAX region's FSDP all-gather of the
expert weights (under a launcher-set FSDP axis, which only its dry-run
sets) has no counterpart yet: the port's experts are whole on the card.

Pliant knob: ``top_k`` override (expert perforation): routing to fewer
experts cuts the active products at a bounded quality loss.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import collectives, implied
from repro_torch.kernels import ops as kops
from repro_torch.models.common import ParamSpec


def moe_specs(cfg: ModelConfig):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
    return {
        "wg": ParamSpec((d, e), (None, None)),
        "wi_gate": ParamSpec((e, d, f), ("expert", "embed", "mlp")),
        "wi_up": ParamSpec((e, d, f), ("expert", "embed", "mlp")),
        "wo": ParamSpec((e, f, d), ("expert", "mlp", "embed")),
    }


def _capacity(n_tokens: int, top_k: int, n_experts: int, cf: float,
              align: int = 8) -> int:
    """Slots an expert takes from a call of ``n_tokens`` tokens: the
    capacity factor's share, rounded up to ``align`` (at least ``align``).
    A Python int: the token count is static."""
    c = int(cf * n_tokens * top_k / n_experts)
    return max(align, -(-c // align) * align)


def _top_k(probs, k: int):
    """The ``k`` largest of each row, largest first, ties to the lower
    index: ``jax.lax.top_k``'s order (``torch.topk`` breaks ties in no set
    order), from a stable descending sort."""
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def _route(x2, wg, top_k: int, capacity: int, n_experts: int):
    """x2: (T, D). Returns (slots (T,k) int64, gates (T,k) in x2's dtype,
    keep (T,k) bool, aux fp32 scalar).

    Each (token, choice) entry goes to slot ``expert * capacity + rank``,
    its rank among the expert's entries in token order; an entry past the
    capacity is dropped (``keep`` False) and parked on the expert's last
    slot, where it adds zeros."""
    logits = (x2 @ wg).float()                              # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate, ids = _top_k(probs, top_k)                        # (T, k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    flat_e = ids.reshape(-1)                                # (T*k,)
    n = flat_e.shape[0]
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = torch.zeros(n_experts, dtype=torch.int64,
                         device=x2.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    seg_start = torch.cumsum(counts, 0) - counts
    rank = torch.arange(n, device=x2.device) - seg_start[sorted_e]
    keep_sorted = rank < capacity
    slot_sorted = sorted_e * capacity + torch.clamp(rank, max=capacity - 1)
    slot = torch.empty_like(flat_e).scatter_(0, order, slot_sorted)
    keep = torch.empty_like(keep_sorted).scatter_(0, order, keep_sorted)
    me = probs.mean(0)
    ce = counts.float() / n
    aux = n_experts * torch.sum(me * ce)
    return (slot.reshape(-1, top_k), gate.to(x2.dtype),
            keep.reshape(-1, top_k), aux)


def _bmm_f32(a, b):
    """``a @ b`` batched with an fp32 output and fp32 sums of the exact
    products (the JAX package's ``preferred_element_type=float32``): on the
    card (and on ``meta``, the dry-run's trace of the card's program)
    cuBLAS writes the fp32 accumulators without rounding them to the
    inputs' dtype; on the CPU, and where autograd needs the product's
    gradient (``bmm`` with ``out_dtype`` has no derivative), the operands
    are upcast, which is exact."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    grad = torch.is_grad_enabled() and (a.requires_grad or b.requires_grad)
    if a.device.type in ("cuda", "meta") and not grad:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _expert_ffn(xe, wi_gate, wi_up, wo, precision: str):
    """xe: (E, C, D); weights (E, D, F) / (E, F, D). Returns (E, C, D).
    int8: each product for all experts in one ``quantized_matmul``, the
    gate's output (in x's dtype) cast to fp32 for the SiLU. Precise: the
    gate product's output in fp32, SiLU in fp32, the others in x's
    dtype."""
    if precision == "int8":
        qmm = kops.quantized_matmul
        g = F.silu(qmm(xe, wi_gate).float())
        u = qmm(xe, wi_up)
        return qmm(g.to(xe.dtype) * u, wo)
    g = F.silu(_bmm_f32(xe, wi_gate))
    u = torch.bmm(xe, wi_up)
    return torch.bmm(g.to(xe.dtype) * u, wo)


def _dispatch(params, x2, cfg: ModelConfig, top_k: int):
    """Route the tokens x2: (T, D) with the capacity of T tokens and fill
    the (E, C, D) buffer. Returns (buffer, flat slots, gates, keep,
    aux)."""
    E = cfg.moe.n_experts
    T, D = x2.shape
    C = _capacity(T, top_k, E, cfg.moe.capacity_factor)
    slot, gate, keep, aux = _route(x2, params.wg, top_k, C, E)
    flat_slot = slot.reshape(-1)
    flat_keep = keep.reshape(-1)
    tok_idx = torch.arange(T * top_k, device=x2.device) // top_k
    src = torch.where(flat_keep[:, None], x2[tok_idx], 0)
    buf = torch.zeros((E * C, D), dtype=x2.dtype, device=x2.device)
    buf.index_add_(0, flat_slot, src)       # a kept slot receives one entry
    return buf.view(E, C, D), flat_slot, gate, keep, aux


def _combine(ye, flat_slot, gate, keep, dtype):
    """Each token's kept entries of the experts' output ye: (E, C, D),
    weighted by their gates."""
    T, k = gate.shape
    D = ye.shape[-1]
    y = ye.reshape(-1, D)[flat_slot].reshape(T, k, D)
    return torch.sum(y * (gate * keep)[..., None], dim=1).to(dtype)


def _moe_local(params, x2, cfg: ModelConfig, top_k: int, precision: str):
    """MoE on the tokens x2: (T, D), capacity from T. Returns (y (T, D),
    aux)."""
    xe, flat_slot, gate, keep, aux = _dispatch(params, x2, cfg, top_k)
    ye = _expert_ffn(xe, params.wi_gate, params.wi_up, params.wo, precision)
    return _combine(ye, flat_slot, gate, keep, x2.dtype), aux


def _expert_weights(params, mesh, ep_axis: str, j: int):
    """Expert shard j's (wi_gate, wi_up, wo): its E/m experts."""
    el = params.wi_gate.shape[0] // mesh.shape[ep_axis]
    return [w[j * el:(j + 1) * el]
            for w in (params.wi_gate, params.wi_up, params.wo)]


def _moe_ep(params, x2, cfg: ModelConfig, top_k: int, precision: str,
            mesh, ep_axis: str, tok_axes, routing=None):
    """The expert-parallel region, position by position: x2 (T, D) split
    over ``tok_axes``; returns (y (T, D), aux averaged over
    ``tok_axes``). Appends each position's (coordinates, keep mask) to
    ``routing`` when given."""
    spec = (tok_axes, None)
    coords = collectives.positions(mesh)
    names = list(mesh.shape)
    e_ax = names.index(ep_axis)
    m = mesh.shape[ep_axis]
    routed = {c: _dispatch(params, collectives.block(x2, spec, mesh, c),
                           cfg, top_k) for c in coords}
    if routing is not None:
        routing.extend((c, routed[c][3]) for c in coords)
    E, C, D = routed[coords[0]][0].shape
    el = E // m
    nbytes = E * C * D * x2.element_size()
    collectives.WIRE.log(ep_axis, "all_to_all", m, nbytes)
    back = {}
    for group in collectives._groups(mesh, ep_axis):
        # expert shard j receives experts j*el:(j+1)*el from every member
        ys = []
        for j, c in enumerate(group):
            xe = torch.cat([routed[i][0][j * el:(j + 1) * el]
                            for i in group], dim=1)      # (el, m*C, D)
            ys.append(_expert_ffn(xe, *_expert_weights(
                params, mesh, ep_axis, c[e_ax]), precision))
        for i, c in enumerate(group):
            back[c] = torch.cat([ye[:, i * C:(i + 1) * C] for ye in ys],
                                dim=0)                     # (E, C, D)
    collectives.WIRE.log(ep_axis, "all_to_all", m, nbytes)
    ys = {c: _combine(back[c], *routed[c][1:4], x2.dtype) for c in coords}
    aux = {c: routed[c][4] for c in coords}
    for ax in tok_axes:
        aux = collectives.pmean_blocks(aux, mesh, ax)
    # the token dim's blocks in order, each from the first position that
    # holds it
    first = {}
    for c in coords:
        first.setdefault(collectives._coord_index(c, mesh, tok_axes)[0], c)
    y = torch.cat([ys[first[i]] for i in sorted(first)], dim=0)
    return y, aux[coords[0]]


def _moe_ep_position(params, x2, cfg: ModelConfig, top_k: int,
                     precision: str):
    """One position's program of the expert-parallel region over
    ``model``, what the dry-run traces (``dist.implied.PLAN`` with ``ep``
    shards): x2 (T, D) are the tokens the position's batch rows hold
    (whole over ``model``) and the expert weights its E/m experts. It
    routes its 1/m of the tokens (all of them when T does not divide),
    sends E/m experts' rows to each shard and takes m members' rows for
    its own (the members' buffers are alike under the trace: its own, m
    times), runs its experts, sends the rows back, combines, and
    all-gathers its tokens' outputs over ``model``. The exchanges go to
    ``WIRE`` as ``_moe_ep``'s do."""
    plan = implied.PLAN
    m, axes = plan.ep, dict(plan.axes)
    T = x2.shape[0]
    split = T % m == 0
    xs = x2[:T // m] if split else x2
    buf, flat_slot, gate, keep, aux = _dispatch(params, xs, cfg, top_k)
    E, C, D = buf.shape
    el = params.wi_gate.shape[0]
    nbytes = E * C * D * x2.element_size()
    collectives.WIRE.log("model", "all_to_all", m, nbytes)
    xe = torch.cat([buf[:el]] * m, dim=1)                 # (el, m*C, D)
    ye = _expert_ffn(xe, params.wi_gate, params.wi_up, params.wo, precision)
    collectives.WIRE.log("model", "all_to_all", m, nbytes)
    back = torch.cat([ye[:, :C]] * (E // el), dim=0)      # (E, C, D)
    y = _combine(back, flat_slot, gate, keep, x2.dtype)
    for ax in (tuple(axes) if split else ("model",)):
        collectives.WIRE.log(ax, "all_reduce", axes[ax], aux.element_size())
    if split:
        implied.record("all-gather", y.numel() * y.element_size() * m,
                       "model", m)
        y = torch.cat([y] * m, dim=0)
    return y, aux


def moe(params, x, cfg: ModelConfig, *, top_k: int = 0,
        precision: str = "bf16", ep_axis: Optional[str] = None, mesh=None,
        routing=None):
    """x: (B, S, D) -> (y, aux_loss); ``top_k`` 0 is the config's. Without
    ``ep_axis`` routes all B * S tokens together (the capacity follows
    B * S). With ``ep_axis`` and ``mesh``: expert parallelism, the tokens
    over every mesh axis when B * S divides the mesh, else over
    ``ep_axis`` when it divides that, else (a tiny batch) routed together
    as without. ``routing``, a list, receives each expert-parallel
    position's (coordinates, keep mask (T_local, top_k))."""
    B, S, D = x.shape
    top_k = top_k or cfg.moe.top_k
    x2 = x.reshape(-1, D)
    if implied.PLAN is not None and implied.PLAN.ep > 1:
        y, aux = _moe_ep_position(params, x2, cfg, top_k, precision)
        return y.reshape(B, S, D), aux
    if ep_axis is not None and mesh is not None:
        T = B * S
        n_all = math.prod(mesh.shape.values())
        tok_axes = (tuple(mesh.shape) if T % n_all == 0 else
                    (ep_axis,) if T % mesh.shape[ep_axis] == 0 else None)
        if tok_axes is not None:
            y, aux = _moe_ep(params, x2, cfg, top_k, precision, mesh,
                             ep_axis, tok_axes, routing)
            return y.reshape(B, S, D), aux
    y, aux = _moe_local(params, x2, cfg, top_k, precision)
    return y.reshape(B, S, D), aux
