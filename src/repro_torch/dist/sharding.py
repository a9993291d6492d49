"""Layout plans of the mesh paths. Counterpart of ``batch_pspec``,
``PagedDecodePlan`` / ``paged_decode_plan`` and ``PrefillPlan`` /
``prefill_plan`` in the JAX package's ``dist/sharding.py``: pure functions
of ``mesh.shape``, so they take the port's ``launch.mesh.Mesh`` or any
object with that mapping.

``kv_head_axis`` is reported as the JAX package reports it; the port's
ring and its sharded paged decode run all heads in every shard (one device
holds every shard), so neither splits the heads over that axis yet.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

from repro_torch.configs.base import ModelConfig


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    flat = axes if isinstance(axes, tuple) else (axes,)
    n = 1
    for a in flat:
        n *= mesh.shape[a]
    return n


def batch_axes(global_batch: int, mesh) -> Optional[Union[str, Tuple[str,
                                                                      ...]]]:
    """The batch dim's mesh axes, ``batch_pspec``'s one entry: greedily
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
