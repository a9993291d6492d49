"""AdamW with a warmup + cosine schedule, global-norm clipping and fp32
moments. Counterpart of the JAX package's ``train/optim.py``.

``adamw_update`` takes an optional ``grad_reduce`` hook applied to the raw
gradients before clipping: the seam where ``dist.collectives.grad_sync``
(the owned gradient-sync region: the in-pod mean plus, when the knobs call
for it, the int8-compressed cross-pod wire) plugs in without the
optimizer knowing about meshes.

Parameters are a ``ParamTree``; gradients and the moments are dicts keyed
by the parameter's name (``named_parameters()``). Where the JAX package
returns new trees, ``adamw_update`` writes the parameters and moments in
place, which keeps one copy of each on the card, at fixed addresses that a
CUDA graph of the train step can hold.

The step's schedule scalars (the learning rate and the two bias
corrections) are computed on the host in fp32 from ``OptState.step`` (a
host int) and read by the update from a (3,) fp32 tensor on the
parameters' device (``schedule``, ``schedule_on``), which a captured step
rewrites before each replay by one copy from pinned memory: the update's
arithmetic is the same, eager or captured.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional

import torch


class OptState(NamedTuple):
    step: int
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]


class OptConfig(NamedTuple):
    lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def init_opt(params) -> OptState:
    def zeros():
        return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for k, p in params.named_parameters()}
    return OptState(step=0, m=zeros(), v=zeros())


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def lr_at(cfg: OptConfig, step: int) -> float:
    """The schedule at ``step``, computed in fp32 as the JAX package does."""
    if step < cfg.warmup:
        return float(_f32(cfg.lr) * (step + 1) / max(cfg.warmup, 1))
    frac = torch.clamp(_f32(step - cfg.warmup)
                       / max(cfg.total_steps - cfg.warmup, 1), 0.0, 1.0)
    return float(_f32(cfg.lr) * 0.5 * (1.0 + torch.cos(_f32(math.pi) * frac)))


def schedule(cfg: OptConfig, step: int) -> torch.Tensor:
    """``(lr, b1c, b2c)`` of the update that follows ``step`` as a (3,)
    fp32 CPU tensor: ``lr_at(cfg, step)`` and the bias corrections ``1 -
    b ** (step + 1)``, computed in fp32 as the JAX package does."""
    t = step + 1
    return torch.stack([_f32(lr_at(cfg, step)), 1.0 - _f32(cfg.b1) ** t,
                        1.0 - _f32(cfg.b2) ** t])


def schedule_on(cfg: OptConfig, step: int, device,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``schedule(cfg, step)`` on ``device``, written into ``out`` when
    given. On the card it is one asynchronous copy from pinned memory (the
    caching host allocator keeps the pinned block until the copy has run),
    so writing it waits for nothing, and a copy written after a step's
    kernels reaches the device after they have read the previous value."""
    host = schedule(cfg, step)
    if torch.device(device).type == "cuda":
        host = host.pin_memory()
    if out is None:
        return host.to(device, non_blocking=True)
    return out.copy_(host, non_blocking=True)


def global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum(x.float().square().sum() for x in tensors))


@torch.no_grad()
def adamw_update(grads: Dict[str, torch.Tensor], opt: OptState, params,
                 cfg: OptConfig, sched: Optional[torch.Tensor] = None,
                 grad_reduce: Optional[Callable] = None):
    """One AdamW step. ``grads`` maps each parameter's name to its gradient;
    ``grad_reduce`` (a {name: tensor} -> {name: tensor} collective) is
    applied to them first.
    Updates ``params`` and the moments in place; returns (params, new_opt,
    metrics), ``metrics["lr"]`` a 0-dim fp32 tensor. ``sched`` is
    ``schedule_on(cfg, opt.step, ...)`` on the parameters' device (made
    here when None); the update reads the step only from it.

    Weight decay applies to the leaves that are at least 2-D in the JAX
    package's tree, where every layer's leaf is stacked over the layer
    groups (an encoder-decoder's over its encoder and decoder layers): so
    a layer's 1-D leaves (norm scales, ``a_log``, ``dt_bias``, ``d_skip``)
    decay too, and only ``final_norm`` (and ``enc_norm``) do not."""
    if grad_reduce is not None:
        grads = grad_reduce(grads)
    named = dict(params.named_parameters())
    gnorm = global_norm(grads.values())
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    if sched is None:
        sched = schedule_on(cfg, opt.step, gnorm.device)
    lr, b1c, b2c = sched.unbind()
    for k, p in named.items():
        g = grads[k].float() * scale
        m, v = opt.m[k], opt.v[k]
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * g.square())
        update = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        stacked = k.startswith(("layers.", "enc.", "dec."))
        decay = cfg.weight_decay if p.ndim + stacked >= 2 else 0.0
        pf = p.float()
        p.copy_((pf - lr * (update + decay * pf)).to(p.dtype))
    return params, OptState(opt.step + 1, opt.m, opt.v), {
        "grad_norm": gnorm, "lr": lr}
