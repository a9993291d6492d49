"""The train step factory, parameterised by ``ApproxKnobs``. Counterpart of
the JAX package's ``train/step.py`` (``make_train_step``) on one device: no
mesh and no gradient-sync region; and the serving engine's K-step
megastep (``make_paged_megastep``).

``make_train_step(cfg, knobs, ...)`` returns one plain Python closure per
approximate variant; the Pliant actuator (``core/variants``) keeps one per
variant and switches which one runs at a step boundary. Gradient
accumulation over ``n_micro`` micro-batches sums the gradients in fp32.
"""
from __future__ import annotations

import torch

from repro_torch.approx.knobs import PRECISE, ApproxKnobs
from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm as lm_mod
from repro_torch.train import optim


def make_train_step(cfg: ModelConfig, knobs: ApproxKnobs = PRECISE, *,
                    opt_cfg: optim.OptConfig = optim.OptConfig(),
                    n_micro: int = 1, remat: str = "full"):
    """Returns step(params, opt, batch) -> (params, opt, metrics); the
    parameters and moments are updated in place."""

    def grad_fn(params, batch):
        named = dict(params.named_parameters())
        loss, metrics = lm_mod.lm_loss(params, batch, cfg, knobs, remat=remat)
        grads = torch.autograd.grad(loss, list(named.values()),
                                    allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(named.items(), grads)}
        return loss.detach(), metrics, grads

    def step(params, opt, batch):
        params.requires_grad_(True)
        if n_micro == 1:
            loss, metrics, grads = grad_fn(params, batch)
        else:
            b = batch["tokens"].shape[0]
            assert b % n_micro == 0, (b, n_micro)
            gsum, loss = None, 0.0
            for mb in batch["tokens"].chunk(n_micro):
                l, metrics, g = grad_fn(params, {"tokens": mb})
                g = {k: v.float() for k, v in g.items()}
                gsum = g if gsum is None else {k: gsum[k] + g[k] for k in g}
                loss = loss + l
            grads = {k: v / n_micro for k, v in gsum.items()}
            loss = loss / n_micro
        params, opt, opt_metrics = optim.adamw_update(grads, opt, params,
                                                      opt_cfg)
        metrics = {k: v.detach() if torch.is_tensor(v) else v
                   for k, v in metrics.items()}
        return params, opt, dict(metrics, loss=loss, **opt_metrics)

    return step


def make_paged_megastep(cfg: ModelConfig, knobs: ApproxKnobs = PRECISE, *,
                        k: int, temperature: float = 0.0, seed: int = 0,
                        eos_id: int = -1):
    """Returns step(params, cur, pos, alive, uids, draws, budget, caches)
    -> (toks (B, K), cur, pos, alive, draws, budget, caches): K decode steps
    with on-device sampling and stop masking (``lm.decode_megastep``). The
    carry and the caches are updated in place, so the engine chains
    megasteps on the device without a host sync between them, and a graph
    captured over ``k=1`` replays on the same tensors."""

    def step(params, cur, pos, alive, uids, draws, budget, caches):
        return lm_mod.decode_megastep(
            params, cur, pos, alive, uids, draws, budget, caches, cfg, knobs,
            k=k, temperature=temperature, seed=seed, eos_id=eos_id)
    return step
