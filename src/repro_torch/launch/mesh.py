"""A device mesh for the port. Counterpart of the JAX package's
``launch/mesh.py`` (``make_mesh``, ``make_production_mesh``) over
``jax.sharding.Mesh``.

A ``Mesh`` names its axes and gives each position a torch device and an
ordinal ``id`` (the counterpart of ``jax.Device.id``; row-major over the
shape for a fresh mesh). Its ``shape`` is an ordered dict of axis name ->
size, as ``jax.sharding.Mesh.shape`` reads, so the plan functions of
``dist.sharding`` take either mesh. A mesh can be built over a subset of
another mesh's positions (``ids``), which ``dist.elastic.surviving_mesh``
does after a revocation. Every position of a mesh here is the same device:
the ring prefill runs its sequence shards one after another on that
device, the sharded paged decode one ``paged_attention`` launch per
slot-affinity shard, and the owned collectives of ``dist.collectives``
(the gradient-sync region, the pod sync, MoE's expert exchange) their
positions' blocks in turn. A mesh whose positions name different devices
raises: placing positions on several cards, each collective a
``torch.distributed`` call on its axis's process group, is ROADMAP queue 1
item 6 ("the mesh's positions on several cards").
"""
from __future__ import annotations

import collections
import math
from typing import Optional, Sequence

import torch


class Mesh:
    """``shape``: one size per name of ``axis_names``; ``devices``: one
    torch device per position, in row-major order; ``ids``: each
    position's ordinal (default ``0 .. n-1``)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 devices: Sequence, ids: Optional[Sequence[int]] = None):
        shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} and axes {axis_names} "
                             "differ in length")
        if len(devices) != math.prod(shape):
            raise ValueError(f"mesh {shape} needs {math.prod(shape)} "
                             f"devices, got {len(devices)}")
        ids = tuple(range(len(devices))) if ids is None else \
            tuple(int(i) for i in ids)
        if len(ids) != len(devices) or len(set(ids)) != len(ids):
            raise ValueError(f"mesh {shape} needs {len(devices)} distinct "
                             f"position ids, got {ids}")
        devices = [_indexed(torch.device(d)) for d in devices]
        if len(set(devices)) > 1:
            raise NotImplementedError(
                f"mesh positions on {sorted(map(str, set(devices)))}: a mesh "
                "spread over several devices (collectives over NCCL) is not "
                "ported yet (ROADMAP queue 1 item 6, \"the mesh's positions "
                "on several cards\"); every position must be the same "
                "device")
        self.shape = collections.OrderedDict(zip(axis_names, shape))
        self.devices = devices
        self.ids = ids
        self.device = devices[0]

    def __repr__(self):
        dims = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return f"Mesh({dims}; {self.device})"


def _indexed(device: torch.device) -> torch.device:
    """``cuda`` names the current card, as a tensor's ``.device`` does."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(shape, axes, device="cuda") -> Mesh:
    """A mesh of ``shape`` with every position on ``device``."""
    return Mesh(shape, axes, [device] * math.prod(shape))


def make_production_mesh(multi_pod: bool = False) -> Mesh:
    """The dry-run's mesh: (16, 16) over ("data", "model"), or (2, 16, 16)
    over ("pod", "data", "model"), every position ``meta`` (nothing is
    allocated; the JAX package forces as many host devices)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, "meta")
