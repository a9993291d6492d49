"""Train and serve step factories, parameterised by ``ApproxKnobs``.
Counterpart of the JAX package's ``train/step.py`` on one device (no mesh
and no gradient-sync region): ``make_train_step`` for every family,
``make_serve_step`` (one token against the caches, the encoder-decoder's
with ``enc_out``), ``make_prefill_fn`` (a full forward's last-token
logits), and the serving engine's K-step megastep
(``make_paged_megastep``).

``make_train_step(cfg, knobs, ...)`` returns one plain Python closure per
approximate variant; the Pliant actuator (``core/variants``) keeps one per
variant and switches which one runs at a step boundary. Gradient
accumulation over ``n_micro`` micro-batches splits every leaf of the batch
(``tokens``, ``frames``, ``prefix_embeds``) and sums the gradients in fp32.
"""
from __future__ import annotations

import torch

from repro_torch.approx.knobs import PRECISE, ApproxKnobs
from repro_torch.configs.base import ModelConfig
from repro_torch.models import api
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import lm as lm_mod
from repro_torch.train import optim


def _micro_split(batch, n_micro: int):
    """A list of ``n_micro`` batches, every leaf cut along its rows."""
    for x in batch.values():
        assert x.shape[0] % n_micro == 0, (x.shape[0], n_micro)
    parts = {k: x.chunk(n_micro) for k, x in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n_micro)]


def make_train_step(cfg: ModelConfig, knobs: ApproxKnobs = PRECISE, *,
                    opt_cfg: optim.OptConfig = optim.OptConfig(),
                    n_micro: int = 1, remat: str = "full"):
    """Returns step(params, opt, batch) -> (params, opt, metrics); the
    parameters and moments are updated in place."""
    loss_fn = api.loss_fn(cfg)

    def grad_fn(params, batch):
        named = dict(params.named_parameters())
        loss, metrics = loss_fn(params, batch, knobs=knobs, remat=remat)
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
            gsum, loss = None, 0.0
            for mb in _micro_split(batch, n_micro):
                l, metrics, g = grad_fn(params, mb)
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


def make_serve_step(cfg: ModelConfig, knobs: ApproxKnobs = PRECISE):
    """Returns step(params, tokens, position, caches[, enc_out]) ->
    (logits, caches): one new token against the KV/SSM caches (updated in
    place); the encoder-decoder's step also takes the encoder's output."""
    decode = api.decode_fn(cfg)

    if cfg.family == "encdec":
        def step(params, tokens, position, caches, enc_out):
            return decode(params, tokens, position, caches, enc_out,
                          knobs=knobs)
        return step

    def step(params, tokens, position, caches):
        return decode(params, tokens, position, caches, knobs=knobs)
    return step


def make_prefill_fn(cfg: ModelConfig, knobs: ApproxKnobs = PRECISE, *,
                    remat: str = "full"):
    """Returns prefill(params, batch) -> the last-token logits (B, V) fp32
    of a full forward over ``batch["tokens"][:, :-1]`` (the prefill cell):
    after the encoder over ``frames`` for the encoder-decoder, after the
    ``prefix_embeds`` for the vlm."""

    def prefill(params, batch):
        if cfg.family == "encdec":
            enc_out = encdec_mod.encode(params, batch["frames"], cfg, knobs,
                                        remat=remat)
            h = encdec_mod.decode_hidden(params, batch["tokens"][:, :-1],
                                         enc_out, cfg, knobs, remat=remat)
        else:
            h, _ = lm_mod.forward_hidden(
                params, batch["tokens"][:, :-1], cfg, knobs, remat=remat,
                prefix_embeds=batch.get("prefix_embeds"))
        return lm_mod.logits_fn(params, h[:, -1], cfg)

    return prefill


def make_paged_megastep(cfg: ModelConfig, knobs: ApproxKnobs = PRECISE, *,
                        k: int, temperature: float = 0.0, seed: int = 0,
                        eos_id: int = -1, shards=1):
    """Returns step(params, cur, pos, alive, uids, draws, budget, caches)
    -> (toks (B, K), cur, pos, alive, draws, budget, caches): K decode steps
    with on-device sampling and stop masking (``lm.decode_megastep``). The
    carry and the caches are updated in place, so the engine chains
    megasteps on the device without a host sync between them, and a graph
    captured over ``k=1`` replays on the same tensors."""

    def step(params, cur, pos, alive, uids, draws, budget, caches):
        return lm_mod.decode_megastep(
            params, cur, pos, alive, uids, draws, budget, caches, cfg, knobs,
            k=k, temperature=temperature, seed=seed, eos_id=eos_id,
            shards=shards)
    return step
