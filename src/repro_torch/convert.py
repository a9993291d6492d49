"""Carry weights and state across between the JAX package and the port,
through numpy only (the port imports nothing of the JAX package).

``params_from_numpy`` takes the JAX package's param pytree (as returned by
``repro.models.api.init``, each leaf converted with ``np.asarray``) and
builds the port's ``ParamTree``: the leading group axis of
``groups.pos<j>`` is unstacked into one block per layer, and every weight
keeps the ``x @ W`` orientation. ``caches_to_numpy`` lays the port's caches
out as the JAX package does (one ``PagedKVCache`` per pattern position,
leaves stacked over layer groups), so tests can compare them leaf by leaf.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import PagedKVCache
from repro_torch.models.common import ParamTree, tree_map


def params_from_numpy(tree, cfg: ModelConfig, device="cpu",
                      dtype=torch.float32) -> ParamTree:
    def leaf(a):
        return torch.tensor(np.asarray(a, np.float32), dtype=dtype,
                            device=device)

    period = len(cfg.pattern)
    out = {k: leaf(tree[k]) for k in ("embed", "final_norm", "unembed")
           if k in tree}
    out["layers"] = []
    for i in range(cfg.n_layers):
        g, j = divmod(i, period)
        out["layers"].append(
            tree_map(lambda a: leaf(np.asarray(a)[g]),
                     tree["groups"][f"pos{j}"]))
    return ParamTree(out)


def caches_to_numpy(caches):
    """The port's paged caches as numpy, in the JAX package's layout."""
    return tuple(PagedKVCache(*(x.cpu().numpy() for x in c)) for c in caches)
