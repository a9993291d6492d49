"""Carry weights and state across between the JAX package and the port,
through numpy only (the port imports nothing of the JAX package).

``params_from_numpy`` takes the JAX package's param pytree (as returned by
``repro.models.api.init``, each leaf converted with ``np.asarray``) and
builds the port's ``ParamTree``: the leading group axis of
``groups.pos<j>`` is unstacked into one block per layer (attention or
Mamba; an empty block at a SHARED_ATTN position, which has no
``pos<j>``), zamba2's ``shared`` block is carried once, and every weight
keeps the ``x @ W`` orientation. ``tree_to_numpy`` goes back: any name ->
tensor map of the port's parameters (the parameters themselves, their
gradients, AdamW moments) becomes the JAX package's nested layout with the
layers restacked and ``shared`` nested once. ``caches_to_numpy`` lays the
port's caches out as the JAX package does (one ``KVCache``,
``PagedKVCache`` or ``MambaCache`` per pattern position, leaves stacked
over layer groups), so tests can compare them leaf by leaf.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import SHARED_ATTN, ModelConfig
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
            {} if cfg.pattern[j] == SHARED_ATTN else
            tree_map(lambda a: leaf(np.asarray(a)[g]),
                     tree["groups"][f"pos{j}"]))
    if "shared" in tree:
        out["shared"] = tree_map(leaf, tree["shared"])
    return ParamTree(out)


def tree_to_numpy(named, cfg: ModelConfig):
    """{"layers.<i>.<path>": tensor, "<top>.<path>": tensor} (as from
    ``named_parameters()``) -> the JAX package's nested numpy tree, layer
    ``g * period + j`` restacked at index ``g`` of ``groups.pos<j>``, the
    other names (``embed``, ``shared.attn.wq``, ...) nested as they
    read."""
    period = len(cfg.pattern)
    out, layers = {}, {}
    for name, t in named.items():
        a = t.detach().cpu().numpy()
        parts = name.split(".")
        if parts[0] != "layers":
            node = out
            for k in parts[:-1]:
                node = node.setdefault(k, {})
            node[parts[-1]] = a
            continue
        g, j = divmod(int(parts[1]), period)
        node = layers.setdefault(f"pos{j}", {})
        for k in parts[2:-1]:
            node = node.setdefault(k, {})
        node.setdefault(parts[-1], {})[g] = a

    def stack(node):
        if all(isinstance(k, int) for k in node):
            return np.stack([node[g] for g in sorted(node)])
        return {k: stack(v) for k, v in node.items()}
    if layers:
        out["groups"] = {k: stack(v) for k, v in layers.items()}
    return out


def caches_to_numpy(caches):
    """The port's caches as numpy, in the JAX package's layout (each
    cache's own type, its leaves numpy arrays)."""
    return tuple(type(c)(*(x.cpu().numpy() for x in c)) for c in caches)
