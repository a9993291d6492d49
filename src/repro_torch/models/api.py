"""Family-dispatching model API of the train and serve layers. Counterpart
of the JAX package's ``models/api.py``:

* ``model_specs(cfg)``         the full ``ParamSpec`` tree
* ``init(cfg, seed, dtype, device)``  materialised parameters
* ``abstract(cfg, dtype)``     the same as ``meta`` tensors
* ``loss_fn(cfg)``             (params, batch, knobs, **kw) -> (loss, metrics);
                               ``kw``: ``remat``, and ``ep_axis`` / ``mesh``
                               for expert parallelism
* ``decode_fn(cfg)``           the one-token serve step
* ``input_specs(cfg, shape)``  {name: (shape tuple, dtype)} of a cell's batch
* ``make_inputs(cfg, shape, generator, device)``  a synthetic batch of them

The encoder-decoder family (whisper) goes through ``models/encdec.py``,
every other family through ``models/lm.py`` (the vlm's patch embeddings as
``prefix_embeds``).
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import lm as lm_mod


def model_specs(cfg: ModelConfig):
    if cfg.family == "encdec":
        return encdec_mod.encdec_specs(cfg)
    return lm_mod.lm_specs(cfg)


def init(cfg: ModelConfig, seed: int = 0, dtype=torch.bfloat16,
         device="cuda"):
    """Random weights from ``seed`` on ``device`` (CUDA unless the caller
    asks for the CPU)."""
    if cfg.family == "encdec":
        return encdec_mod.init_encdec(cfg, seed, dtype, device)
    return lm_mod.init_lm(cfg, seed, dtype, device)


def abstract(cfg: ModelConfig, dtype=torch.bfloat16):
    """``init``'s parameters as ``meta`` tensors, shapes and dtypes with no
    storage (the JAX package's ``api.abstract``: ``ssm_a`` and ``ssm_dt``
    leaves in fp32 whatever ``dtype`` is)."""
    from repro_torch.models.common import ParamTree, tree_map

    def mk(s):
        dt = torch.float32 if s.init in ("ssm_a", "ssm_dt") else dtype
        return torch.empty(s.shape, dtype=dt, device="meta")
    return ParamTree(tree_map(mk, model_specs(cfg)))


def loss_fn(cfg: ModelConfig):
    if cfg.family == "encdec":
        return functools.partial(encdec_mod.encdec_loss, cfg=cfg)
    return functools.partial(lm_mod.lm_loss, cfg=cfg)


def decode_fn(cfg: ModelConfig):
    if cfg.family == "encdec":
        return functools.partial(encdec_mod.encdec_decode_step, cfg=cfg)
    return functools.partial(lm_mod.decode_step, cfg=cfg)


def input_specs(cfg: ModelConfig, shape: ShapeConfig
                ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """{name: (shape, dtype)} of every model input of one cell: tokens are
    int32, embeddings bf16, as in the JAX package."""
    B, S = shape.global_batch, shape.seq_len
    tok, emb = torch.int32, torch.bfloat16
    if shape.kind in ("train", "prefill"):
        if cfg.family == "encdec":
            return {"tokens": ((B, S + 1), tok),
                    "frames": ((B, cfg.encoder_seq, cfg.d_model), emb)}
        if cfg.family == "vlm":
            P = cfg.n_prefix_tokens
            return {"tokens": ((B, S - P + 1), tok),
                    "prefix_embeds": ((B, P, cfg.d_model), emb)}
        return {"tokens": ((B, S + 1), tok)}
    # decode: one new token against a seq_len-deep cache
    out = {"tokens": ((B, 1), tok), "position": ((B,), tok)}
    if cfg.family == "encdec":
        out["enc_out"] = ((B, cfg.encoder_seq, cfg.d_model), emb)
    return out


def make_inputs(cfg: ModelConfig, shape_or_specs,
                generator: torch.Generator, device="cpu"):
    """A synthetic batch matching ``input_specs``, drawn from
    ``generator`` (a ``torch.Generator`` on ``device``): tokens uniform
    over the vocabulary, ``position`` zeros, embeddings standard normal."""
    specs = (input_specs(cfg, shape_or_specs)
             if isinstance(shape_or_specs, ShapeConfig) else shape_or_specs)
    out = {}
    for name, (shp, dt) in specs.items():
        if name == "position":
            out[name] = torch.zeros(shp, dtype=dt, device=device)
        elif dt == torch.int32:
            out[name] = torch.randint(0, max(cfg.vocab_size, 2), shp,
                                      generator=generator, device=device,
                                      dtype=dt)
        else:
            out[name] = torch.randn(shp, generator=generator,
                                    device=device).to(dt)
    return out
