"""Carry weights and state across between the JAX package and the port,
through numpy only (the port imports nothing of the JAX package).

``params_from_numpy`` takes the JAX package's param pytree (as returned by
``repro.models.api.init``, each leaf converted with ``np.asarray``) and
builds the port's ``ParamTree``: the leading group axis of
``groups.pos<j>`` is unstacked into one block per layer (attention or
Mamba; an empty block at a SHARED_ATTN position, which has no
``pos<j>``), zamba2's ``shared`` block is carried once, and every weight
keeps the ``x @ W`` orientation. The encoder-decoder's tree carries
``enc`` (stacked over ``n_encoder_layers``) and ``dec.pos0`` (stacked over
the layer groups, each with its ``cross`` and ``norm_cross``) across the
same way, to the port's ``enc`` and ``dec`` lists. ``tree_to_numpy`` goes
back: any name -> tensor map of the port's parameters (the parameters
themselves, their gradients, AdamW moments) becomes the JAX package's
nested layout with the layers restacked and ``shared`` nested once, and
``named_from_numpy`` reads such a tree back by name (a checkpoint's
restore). ``caches_to_numpy`` lays the port's caches out as the JAX
package does (one ``KVCache``, ``PagedKVCache`` or ``MambaCache`` per
pattern position, leaves stacked over layer groups), so tests can compare
them leaf by leaf.
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

    def layer(sub, i):
        return tree_map(lambda a: leaf(np.asarray(a)[i]), sub)

    period = len(cfg.pattern)
    out = {k: leaf(tree[k]) for k in ("embed", "final_norm", "unembed",
                                      "enc_norm") if k in tree}
    if "enc" in tree:                                   # encoder-decoder
        out["enc"] = [layer(tree["enc"], i)
                      for i in range(cfg.n_encoder_layers)]
        out["dec"] = [layer(tree["dec"]["pos0"], g)
                      for g in range(cfg.n_groups)]
        return ParamTree(out)
    out["layers"] = []
    for i in range(cfg.n_layers):
        g, j = divmod(i, period)
        out["layers"].append(
            {} if cfg.pattern[j] == SHARED_ATTN else
            layer(tree["groups"][f"pos{j}"], g))
    if "shared" in tree:
        out["shared"] = tree_map(leaf, tree["shared"])
    return ParamTree(out)


def jax_path(name: str, cfg: ModelConfig):
    """Where the port's parameter ``name`` lives in the JAX package's tree:
    (path of keys, index into the stacked leaf's first axis or None).
    Layer ``g * period + j`` is index ``g`` of ``groups.pos<j>``, an
    encoder-decoder's ``enc.<i>`` index ``i`` of ``enc`` and ``dec.<g>``
    index ``g`` of ``dec.pos0``; other names (``embed``,
    ``shared.attn.wq``, ...) nest as they read."""
    parts = name.split(".")
    if parts[0] == "layers":
        g, j = divmod(int(parts[1]), len(cfg.pattern))
        return ("groups", f"pos{j}", *parts[2:]), g
    if parts[0] == "enc":
        return ("enc", *parts[2:]), int(parts[1])
    if parts[0] == "dec":
        return ("dec", "pos0", *parts[2:]), int(parts[1])
    return tuple(parts), None


def _put(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def tree_to_numpy(named, cfg: ModelConfig):
    """{"layers.<i>.<path>": tensor, "<top>.<path>": tensor} (as from
    ``named_parameters()``) -> the JAX package's nested numpy tree, each
    name at its ``jax_path``: the layers restacked, each stacked leaf
    written row by row into one array (a device tensor copied straight
    into its row). Every array is a copy: none shares memory with a tensor
    that training goes on updating in place."""
    out, stacks = {}, {}
    for name, t in named.items():
        path, i = jax_path(name, cfg)
        if i is None:
            _put(out, path, t.detach().to("cpu", copy=True).numpy())
        else:
            stacks.setdefault(path, {})[i] = t
    for path, rows in stacks.items():
        first = rows[min(rows)]
        arr = np.empty((len(rows),) + tuple(first.shape),
                       torch.empty(0, dtype=first.dtype).numpy().dtype)
        for i in sorted(rows):
            torch.from_numpy(arr[i]).copy_(rows[i].detach())
        _put(out, path, arr)
    return out


def named_from_numpy(tree, names, cfg: ModelConfig):
    """The inverse of ``tree_to_numpy``: {name: the numpy array (a view of
    its row for a stacked leaf)} for each of ``names`` in the JAX
    package's nested ``tree``."""
    out = {}
    for name in names:
        path, i = jax_path(name, cfg)
        a = np.asarray(_get(tree, path))
        out[name] = a if i is None else a[i]
    return out


def caches_to_numpy(caches):
    """The port's caches as numpy, in the JAX package's layout (each
    cache's own type, its leaves numpy arrays)."""
    return tuple(type(c)(*(x.cpu().numpy() for x in c)) for c in caches)
