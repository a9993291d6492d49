"""Logical-axis -> mesh-axis sharding policies and the layout plans of
the mesh paths. Counterpart of the JAX package's ``dist/sharding.py``:
pure functions of ``mesh.shape`` and the configs, so they take the port's
``launch.mesh.Mesh`` or any object with that mapping.

Every module in ``models/`` declares its parameters as ``ParamSpec``
trees with logical axis names (``embed``, ``mlp``, ``q_heads``,
``expert``, ...). ``param_shardings`` maps them onto mesh axes under a
named policy and returns a tree of ``P`` specs with the structure of the
port's ``ParamSpec`` tree (``api.model_specs``: a list of blocks where the
JAX package stacks them over layer groups, so a block's spec is the JAX
spec less its leading ``layers`` entry). ``named_specs`` reads that tree
by the parameters' dotted names, as ``ParamTree.named_parameters`` gives
them.

Policies:

* ``"replicated"``: everything everywhere.
* ``"tp"``: megatron-style tensor parallelism over ``model``: hidden,
  expert and vocab dims sharded, the embed dim replicated.
* ``"fsdp_tp"``: ``tp`` plus the embed dim FSDP-sharded over ``data``.

A dim is sharded only when its size divides the mesh axis, and each mesh
axis is used at most once an array (the first matching dim wins).

Every position of a port mesh is the one card, so these specs record the
layout the JAX package would place; the tensors stay whole, and what
GSPMD computes over them is computed unsplit (``dist.collectives`` runs
the owned regions). ``batch_pspec`` and ``input_shardings`` give the
inputs' specs (key for key with ``api.input_specs``), and ``local_shape``
a leaf's shape at one position under its spec: the dry-run
(``launch/dryrun.py``) builds one position's arguments from them. The JAX
package's ``megastep_shardings`` places the megastep's arguments over
devices and waits, with ``dist/annotate.py``'s in-model sharding
constraints, until the port's positions span cards (ROADMAP queue 1
item 6). ``kv_head_axis`` is reported as the JAX package reports it; the
ring and the sharded paged decode run every head in every shard.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.common import ParamSpec


class P(tuple):
    """A partition spec, ``jax.sharding.PartitionSpec``'s counterpart: one
    entry a dim, each a mesh axis name, a tuple of names, or None
    (replicated); compares equal to the tuple of its entries."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"P({', '.join(map(repr, self))})"


# logical axis name -> mesh axis, per policy. Axes not listed stay replicated.
_TP_RULES = {
    "vocab": "model",
    "q_heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "expert": "model",
    "ssm_inner": "model",
    "ssm_heads": "model",
}

POLICIES = {
    "replicated": {},
    "tp": dict(_TP_RULES),
    "fsdp_tp": dict(_TP_RULES, embed="data"),
}


def default_policy(cfg: ModelConfig) -> str:
    """Weights at production scale never fit replicated: FSDP+TP everywhere."""
    return "fsdp_tp"


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    flat = axes if isinstance(axes, tuple) else (axes,)
    n = 1
    for a in flat:
        n *= mesh.shape[a]
    return n


def _spec_for(spec: ParamSpec, rules, mesh) -> P:
    used = set()
    out = []
    for size, name in zip(spec.shape, spec.axes):
        ax = rules.get(name)
        if (ax is None or ax not in mesh.shape or ax in used
                or size % mesh.shape[ax] != 0):
            out.append(None)
        else:
            out.append(ax)
            used.add(ax)
    return P(*out)


def _map_specs(fn, tree):
    """``fn`` over the ``ParamSpec`` leaves of a nested dict / list tree."""
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_specs(fn, v) for v in tree]
    return fn(tree)


def param_shardings(cfg: ModelConfig, mesh, mode: Optional[str] = None):
    """The ``P`` tree of ``cfg``'s parameters under policy ``mode`` (the
    config's default when None), with ``api.model_specs``' structure."""
    from repro_torch.models import api
    rules = POLICIES[mode or default_policy(cfg)]
    return _map_specs(lambda s: _spec_for(s, rules, mesh),
                      api.model_specs(cfg))


def named_specs(tree, prefix: str = "") -> Dict[str, object]:
    """{dotted name: leaf} of a nested dict / list tree, the names
    ``ParamTree.named_parameters`` gives the same tree's tensors."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(named_specs(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def local_shape(shape, spec, mesh) -> Tuple[int, ...]:
    """The shape of one position's block of a leaf of ``shape`` under
    ``spec``: each dim divided by the sizes of the mesh axes it is split
    over."""
    out = list(shape)
    for d, part in enumerate(spec or ()):
        out[d] //= _axis_size(mesh, tuple(part) if isinstance(
            part, (tuple, list)) else part)
    return tuple(out)


# ----------------------------------------------------------------- inputs --

def batch_pspec(global_batch: int, mesh) -> P:
    """The spec of the batch dim: greedily over (pod, data)."""
    b = batch_axes(global_batch, mesh)
    return P() if b is None else P(b)


def input_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh):
    """{name: spec} matching ``api.input_specs(cfg, shape)`` key for key:
    the batch dim over ``batch_pspec``'s axes, the rest replicated."""
    from repro_torch.models import api
    bspec = batch_pspec(shape.global_batch, mesh)
    b = bspec[0] if len(bspec) else None
    return {name: P(b, *([None] * (len(shp) - 1)))
            for name, (shp, _) in api.input_specs(cfg, shape).items()}

def batch_axes(global_batch: int, mesh) -> Optional[Union[str, Tuple[str,
                                                                      ...]]]:
    """The batch dim's mesh axes (the JAX package's ``batch_pspec``'s one
    entry): greedily
    (pod, data) while each divides ``global_batch``; a name, a tuple of
    names, or None (replicated)."""
    use, n = [], 1
    for a in ("pod", "data"):
        if a in mesh.shape and global_batch % (n * mesh.shape[a]) == 0:
            use.append(a)
            n *= mesh.shape[a]
    if not use:
        return None
    return tuple(use) if len(use) > 1 else use[0]


class PagedDecodePlan:
    """Slot-affinity layout of the sharded paged decode: the batch mesh
    axes the slot and page dims split over, the shard count, and the mesh
    axis (if any) the kv_heads dim additionally splits over.

    A pure function of (cfg, mesh, batch_slots, n_pages): the engine (pool
    sizing) and the decode attention (row ranges, page ranges and block
    table rebasing) derive the same layout independently."""

    def __init__(self, batch_axes, n_shards: int, kv_head_axis):
        self.batch_axes = batch_axes      # mesh axis name or tuple of names
        self.n_shards = n_shards
        self.kv_head_axis = kv_head_axis  # "model" or None (replicated)

    def __repr__(self):
        return (f"PagedDecodePlan(batch_axes={self.batch_axes!r}, "
                f"n_shards={self.n_shards}, "
                f"kv_head_axis={self.kv_head_axis!r})")


def paged_decode_plan(cfg: ModelConfig, mesh, batch_slots: int,
                      n_pages: int = 0):
    """(plan, reason) for sharding the paged decode over the mesh.

    Returns ``(PagedDecodePlan, "")`` when the pool can be split with slot
    affinity (slots and physical pages partitioned over the same batch
    axes, so each shard's launch resolves its block tables entirely against
    its own page range), else ``(None, reason)`` and the caller takes the
    gather path. ``n_pages`` <= 0 skips the page-dim divisibility check
    (pool sizing rounds it up to fit afterwards)."""
    if mesh is None:
        return None, "no mesh (single device)"
    b = batch_axes(batch_slots, mesh)
    if b is None:
        return None, (f"batch_slots={batch_slots} does not divide any batch "
                      "mesh axis — slots cannot split with affinity")
    n = _axis_size(mesh, b)
    if n_pages > 0 and n_pages % n != 0:
        return None, (f"n_pages={n_pages} does not split over batch axes "
                      f"{b!r} (size {n})")
    g_ax = ("model" if ("model" in mesh.shape
                        and cfg.n_kv_heads % mesh.shape["model"] == 0)
            else None)
    return PagedDecodePlan(b, n, g_ax), ""


class PrefillPlan:
    """The single mesh axis an admission chunk's query dim (and the
    rotating K/V context) splits over, the shard count, and the mesh axis
    (if any) the kv_heads dim additionally splits over. A pure function of
    ``(cfg, mesh, chunk_len)``: the engine's banner and the attention cell
    derive the same plan independently. Causal chunks are laid out striped
    and window chunks contiguously; that choice is per attention call, not
    part of the plan."""

    def __init__(self, seq_axis: str, n_shards: int, kv_head_axis):
        self.seq_axis = seq_axis          # single mesh axis name
        self.n_shards = n_shards
        self.kv_head_axis = kv_head_axis  # "model" or None (replicated)

    def __repr__(self):
        return (f"PrefillPlan(seq_axis={self.seq_axis!r}, "
                f"n_shards={self.n_shards}, "
                f"kv_head_axis={self.kv_head_axis!r})")


def prefill_plan(cfg: ModelConfig, mesh, chunk_len: int):
    """(plan, reason) for sequence-sharding one admission chunk's attention.

    Returns ``(PrefillPlan, "")`` when a batch-side mesh axis can carry the
    ring (a single axis from ("pod", "data") with size > 1 that does not
    exceed the chunk length: each shard needs at least one resident query
    row), else ``(None, reason)`` and the caller takes the single-device
    path. The largest eligible axis wins. kv_heads additionally split over
    ``model`` when divisible."""
    if mesh is None:
        return None, "no mesh (single device)"
    cand = [a for a in ("pod", "data") if mesh.shape.get(a, 1) > 1]
    if not cand:
        return None, ("no batch mesh axis (pod/data) with size > 1 to carry "
                      "the sequence ring")
    cand = [a for a in cand if mesh.shape[a] <= chunk_len]
    if not cand:
        return None, (f"chunk_len={chunk_len} shorter than every batch mesh "
                      "axis — no resident query row per shard")
    ax = max(cand, key=lambda a: mesh.shape[a])
    g_ax = ("model" if ("model" in mesh.shape
                        and cfg.n_kv_heads % mesh.shape["model"] == 0)
            else None)
    return PrefillPlan(ax, mesh.shape[ax], g_ax), ""


# ----------------------------------------------------------------- caches --

def abstract_caches(cfg: ModelConfig, batch: int, max_len: int, *,
                    quantized: bool = False, paged=None):
    """The caches ``init_caches`` (or, given ``paged``, a ``PageSpec``,
    ``init_paged_caches``) would make, as meta tensors: shapes and dtypes
    with no storage (``api.abstract_caches``' counterpart)."""
    from repro_torch.models import lm as lm_mod
    if paged is not None:
        assert cfg.family != "encdec", "paged caches: decoder-only path"
        return lm_mod.init_paged_caches(
            cfg, batch, paged.n_pages, paged.page_size, paged.max_pages,
            quantized=quantized, device="meta")
    return lm_mod.init_caches(cfg, batch, max_len, quantized=quantized,
                              device="meta")


def cache_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                    seq_axis: str = "model", quantized: bool = False,
                    paged=None):
    """(spec tree, abstract caches) for sequence-sharded decode.

    Dense KV caches shard the cache-length dim over ``seq_axis`` and the
    batch dim over the batch axes. Paged pools (``paged`` a ``PageSpec``)
    come in two layouts: a slot-affinity spec (``n_shards`` > 1) shards
    the physical-page dim over the batch axes, as the block table's slot
    dim, with the kv_heads dim over ``model`` when it divides; a legacy
    spec shards the page dim over ``seq_axis``. Mamba states have no
    sequence dim; they shard batch only. Leaves are stacked over the layer
    groups (dim 0). Both trees have ``init_caches`` /
    ``init_paged_caches``' structure."""
    from repro_torch.models.attention import KVCache, PagedKVCache
    from repro_torch.models.mamba2 import MambaCache
    caches_abs = abstract_caches(cfg, shape.global_batch, shape.seq_len,
                                 quantized=quantized, paged=paged)
    b = batch_axes(shape.global_batch, mesh)

    def batch_ax(n):
        return b if (b is not None and n % _axis_size(mesh, b) == 0) else None

    def seq_ax(n):
        ok = (seq_axis in mesh.shape and n % mesh.shape[seq_axis] == 0)
        return seq_axis if ok else None

    def one(c):
        if isinstance(c, PagedKVCache):
            block = P(None, batch_ax(c.block.shape[1]), None)
            if getattr(paged, "n_shards", 1) > 1:
                pg = batch_ax(c.kp.shape[1])
                g_ax = ("model" if ("model" in mesh.shape and
                                    c.kp.shape[3] % mesh.shape["model"] == 0)
                        else None)
                kv = P(None, pg, None, g_ax, None)
            else:
                pg = seq_ax(c.kp.shape[1])
                kv = P(None, pg, None, None, None)
            return PagedKVCache(kp=kv, vp=kv, ppos=P(None, pg, None),
                                block=block)
        if isinstance(c, KVCache):
            bb, ss = batch_ax(c.k.shape[1]), seq_ax(c.k.shape[2])
            kv = P(None, bb, ss, None, None)
            return KVCache(k=kv, v=kv, pos=P(None, bb, ss), cursor=P(None))
        assert isinstance(c, MambaCache), type(c)
        return MambaCache(*(P(None, batch_ax(x.shape[1]),
                              *([None] * (x.ndim - 2))) for x in c))

    return tuple(one(c) for c in caches_abs), caches_abs
