"""Sequence layout of the ring-attention chunked-prefill cell. Counterpart
of ``PrefillPlan`` / ``prefill_plan`` in the JAX package's
``dist/sharding.py``: pure functions of ``mesh.shape``, so they take the
port's ``launch.mesh.Mesh`` or any object with that mapping.

``kv_head_axis`` is reported as the JAX package reports it; the port's ring
runs all heads in every shard (one device holds every shard), so it does
not split the heads over that axis yet.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig


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
