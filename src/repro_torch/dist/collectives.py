"""Wire-compressed collectives: the executable side of the Pliant sync
knobs. Counterpart of the JAX package's ``dist/collectives.py``.

* ``compressed_pmean``: mean over a mesh axis with an int8 wire format:
  each position sends (int8 payload, one fp32 scale) instead of fp32, ~4x
  fewer collective bytes. The ``grad_compress`` knob.
* ``grad_sync``: the per-step gradient reduction as one owned region: the
  in-pod mean over ``data`` plus, when the knobs call for it, the
  cross-pod mean in the same region. Whether the pod wire is part of the
  region is fixed when the step is built, so a step under
  ``sync_period > 1`` carries no pod collective (on the card its captured
  graph holds none).
* ``pod_sync_params``: the periodic pod-level parameter sync of the
  ``sync_period`` knob, which the train driver calls every k steps.

Every position of a port mesh is the one card. ``compressed_pmean`` and
the ``*_blocks`` collectives take one tree of blocks a position (``shard``
cuts them from a global tree as a spec gives them) and run the JAX
package's ``shard_map`` region position by position: the positions that
differ only in the axis form a group, each payload is materialised at its
wire dtype, and every member of a group gets the group's result. That is
the general form, for copies that differ (MoE's per-shard aux loss,
blocks split over the axis).

``grad_sync`` and ``pod_sync_params`` take global trees, one tensor a
leaf, so the copies they average are alike: the gradients of the whole
batch, which the unsplit backward gives (the JAX package's GSPMD has
reduced them over the pods before its region), and parameters that every
pod holds alike. A full-precision mean of equal copies is the copy, and
the int8 mean is one quantise-dequantise a block with that block's scale;
they compute that once a block, and record the bytes each collective
would carry. A leaf that its spec splits over the averaged axis (no
policy of ``dist/sharding.py`` makes one) takes the general form.
Spreading the positions over cards makes each collective a
``torch.distributed`` call on that axis's process group.

``WIRE`` keeps running totals of the collectives: calls and the bytes
each position would send, by (axis, collective): an all-reduce 2(n-1)/n
times its payload, an all-gather (n-1) times it, an all-to-all (n-1)/n
times its buffer. A caller takes a ``mark`` and reads what was added
since. A step captured as a CUDA graph records its collectives once, at
the capture.
"""
from __future__ import annotations

import itertools
import math
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch import cost

# the JAX package's HLO name of each collective, and its payload as the
# JAX package's parser takes it, from a position's block of ``payload``
# bytes over n positions (an all-gather's is the gathered result)
_HLO = {"all_reduce": ("all-reduce", 1), "all_gather": ("all-gather", None),
        "all_to_all": ("all-to-all", 1)}


class Wire:
    """The collectives' record (``WIRE``): {(axis, collective): [calls,
    bytes]}, totals since the last ``reset``."""

    def __init__(self):
        self.totals: Dict[Tuple[str, str], List[float]] = {}

    def log(self, axis: str, collective: str, n: int, payload: int) -> None:
        coef = {"all_reduce": 2.0 * (n - 1) / n, "all_gather": float(n - 1),
                "all_to_all": (n - 1) / n}[collective]
        t = self.totals.setdefault((axis, collective), [0, 0.0])
        t[0] += 1
        t[1] += coef * payload
        if n > 1:
            kind, mult = _HLO[collective]
            cost.collective(kind, payload * (mult or n), axis, n,
                            coef * payload, "owned")

    def reset(self) -> None:
        self.totals.clear()

    def mark(self) -> Dict[Tuple[str, str], Tuple[int, float]]:
        return {k: tuple(v) for k, v in self.totals.items()}

    def since(self, mark: Optional[dict] = None
              ) -> Dict[Tuple[str, str], Tuple[int, float]]:
        """{(axis, collective): (calls, bytes)} added since ``mark`` (all
        of them when None)."""
        mark = mark or {}
        out = {}
        for k, (n, b) in self.totals.items():
            n0, b0 = mark.get(k, (0, 0.0))
            if n > n0:
                out[k] = (n - n0, b - b0)
        return out

    def by_axis(self, mark: Optional[dict] = None) -> Dict[str, float]:
        """Bytes each position would send, by axis, since ``mark``."""
        out: Dict[str, float] = {}
        for (axis, _), (_, b) in self.since(mark).items():
            out[axis] = out.get(axis, 0.0) + b
        return out


WIRE = Wire()


# ------------------------------------------------------ per-position blocks --

def positions(mesh) -> List[Tuple[int, ...]]:
    """Every position's coordinates, row-major over ``mesh.shape``."""
    return list(itertools.product(*(range(n) for n in mesh.shape.values())))


def _flat(part) -> Tuple[str, ...]:
    if part is None:
        return ()
    return tuple(part) if isinstance(part, (tuple, list)) else (part,)


def _split(spec) -> set:
    """The mesh axes ``spec`` splits a tensor over."""
    return {a for p in (spec or ()) for a in _flat(p)}


def _coord_index(coord, mesh, axes) -> Tuple[int, int]:
    """(index, count) of ``coord`` along the (flattened) ``axes``."""
    names = list(mesh.shape)
    i, n = 0, 1
    for a in axes:
        size = mesh.shape[a]
        i, n = i * size + coord[names.index(a)], n * size
    return i, n


def block(x: torch.Tensor, spec, mesh, coord) -> torch.Tensor:
    """The block of ``x`` (a view) that position ``coord`` holds under
    ``spec``: each dim with mesh axes split into as many equal parts,
    row-major over those axes."""
    for d, part in enumerate(spec or ()):
        axes = _flat(part)
        if not axes:
            continue
        i, n = _coord_index(coord, mesh, axes)
        size = x.shape[d] // n
        x = x.narrow(d, i * size, size)
    return x


def _block_owners(spec, mesh) -> List[tuple]:
    """One position for each distinct block under ``spec``: the first
    that holds it."""
    owners = {}
    for coord in positions(mesh):
        key = tuple(_coord_index(coord, mesh, _flat(p))[0]
                    for p in (spec or ()))
        owners.setdefault(key, coord)
    return list(owners.values())


def assemble(blocks: Dict[tuple, torch.Tensor], spec, mesh,
             like: torch.Tensor) -> torch.Tensor:
    """The global tensor of ``like``'s shape whose block at each position
    is ``blocks[coord]``; a block that several positions hold is read from
    the first of them."""
    if not _split(spec):
        return blocks[positions(mesh)[0]]
    out = torch.empty(like.shape, dtype=blocks[positions(mesh)[0]].dtype,
                      device=like.device)
    for coord in _block_owners(spec, mesh):
        block(out, spec, mesh, coord).copy_(blocks[coord])
    return out


def _groups(mesh, axis: str) -> List[List[tuple]]:
    """The positions that differ only in ``axis``, group by group, each in
    the axis's order."""
    k = list(mesh.shape).index(axis)
    out: Dict[tuple, List[tuple]] = {}
    for c in positions(mesh):
        out.setdefault(c[:k] + c[k + 1:], []).append(c)
    return list(out.values())


def _mean(xs: List[torch.Tensor]) -> torch.Tensor:
    """The mean of ``xs``: summed pairwise, then divided by their count."""
    n = len(xs)
    while len(xs) > 1:
        xs = [xs[i] + xs[i + 1] if i + 1 < len(xs) else xs[i]
              for i in range(0, len(xs), 2)]
    return xs[0] / n


def _quantize_int8(x: torch.Tensor):
    """Symmetric per-tensor int8: (payload int8, scale fp32 scalar); the
    division and the rounding (half to even) as ``jnp.round`` does."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def pmean_blocks(blocks: Dict[tuple, torch.Tensor], mesh,
                 axis: str) -> Dict[tuple, torch.Tensor]:
    """Full-precision mean over ``axis``: every position's block in the
    group's mean."""
    n = mesh.shape[axis]
    WIRE.log(axis, "all_reduce", n, _nbytes(next(iter(blocks.values()))))
    out = {}
    for grp in _groups(mesh, axis):
        m = _mean([blocks[c] for c in grp])
        out.update(dict.fromkeys(grp, m))
    return out


def compressed_pmean_blocks(blocks: Dict[tuple, torch.Tensor], mesh,
                            axis: str) -> Dict[tuple, torch.Tensor]:
    """Mean over ``axis`` with int8 payloads: each position quantises its
    block (one scale a block), the payloads and scales are gathered, and
    every position takes the mean of the dequantised payloads in fp32,
    cast back to the block's dtype."""
    n = mesh.shape[axis]
    first = next(iter(blocks.values()))
    WIRE.log(axis, "all_gather", n, first.numel())        # int8 payload
    WIRE.log(axis, "all_gather", n, 4)                    # fp32 scale
    out = {}
    for grp in _groups(mesh, axis):
        deq = [q.float() * s for q, s in
               (_quantize_int8(blocks[c]) for c in grp)]
        m = _mean(deq).to(first.dtype)
        out.update(dict.fromkeys(grp, m))
    return out


def _leaves(tree, prefix=""):
    """[(name, tensor)] of a nested dict / list tree of tensors."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out += _leaves(v, f"{prefix}.{k}" if prefix else str(k))
    return out


def _rebuild(tree, values: Dict[str, torch.Tensor], prefix=""):
    if isinstance(tree, dict):
        return {k: _rebuild(v, values, f"{prefix}.{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, values,
                                   f"{prefix}.{k}" if prefix else str(k))
                          for k, v in enumerate(tree))
    return values[prefix]


def _spec_table(tree, pspecs) -> Dict[str, tuple]:
    """{leaf name: spec}, every leaf ``P()`` when ``pspecs`` is None; a
    nested spec tree (``sharding.param_shardings``) or a flat
    {name: spec} map."""
    from repro_torch.dist.sharding import named_specs
    names = [k for k, _ in _leaves(tree)]
    if pspecs is None:
        return dict.fromkeys(names, ())
    table = named_specs(pspecs)
    return {k: tuple(table[k]) for k in names}


def compressed_pmean(per_position: Dict[tuple, object], mesh,
                     axis: str) -> Dict[tuple, object]:
    """Mean over ``axis`` with int8 wire payloads, the JAX function's
    region run per position: ``per_position`` maps each position's
    coordinates to its tree of blocks (``shard``); returns the same map
    of the means."""
    coords = positions(mesh)
    named = {c: dict(_leaves(per_position[c])) for c in coords}
    out = {c: {} for c in coords}
    for name in named[coords[0]]:
        res = compressed_pmean_blocks({c: named[c][name] for c in coords},
                                      mesh, axis)
        for c in coords:
            out[c][name] = res[c]
    return {c: _rebuild(per_position[c], out[c]) for c in coords}


def shard(tree, mesh, pspecs=None) -> Dict[tuple, object]:
    """{coordinates: the tree of blocks that position holds}."""
    specs = _spec_table(tree, pspecs)
    leaves = dict(_leaves(tree))
    return {c: _rebuild(tree, {k: block(x, specs[k], mesh, c)
                               for k, x in leaves.items()})
            for c in positions(mesh)}


def unshard(per_position: Dict[tuple, object], mesh, like, pspecs=None):
    """The global tree of ``like``'s structure from each position's
    blocks (``assemble``)."""
    specs = _spec_table(like, pspecs)
    named = {c: dict(_leaves(t)) for c, t in per_position.items()}
    return _rebuild(like, {
        k: assemble({c: named[c][k] for c in named}, specs[k], mesh, x)
        for k, x in _leaves(like)})


# ---------------------------------------------- the regions on global trees --

def _wire_leaves(names, stacks) -> List[List[str]]:
    """The leaves as the wire carries them: each name alone, or with
    ``stacks`` (a name -> (path, index) function, ``convert.jax_path``)
    the names the JAX package stacks into one leaf over the layer groups
    together."""
    if stacks is None:
        return [[k] for k in names]
    groups: Dict[tuple, List[str]] = {}
    for k in names:
        groups.setdefault(tuple(stacks(k)[0]), []).append(k)
    return list(groups.values())


def _dequantized(xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """What the int8 wire delivers of the blocks ``xs`` sent as one leaf
    (``_quantize_int8`` of their stack, one scale): each dequantised, in
    its dtype."""
    amax = torch.stack([x.float().abs().amax() for x in xs]).amax()
    scale = torch.clamp(amax, min=1e-12) / 127.0
    return [(torch.clamp(torch.round(x.float() / scale), -127, 127)
             * scale).to(x.dtype) for x in xs]


def _int8_leaf(xs: List[torch.Tensor], spec, mesh) -> List[torch.Tensor]:
    """``_dequantized`` block by block under ``spec`` (one scale a block,
    shared by the leaves the wire stacks)."""
    if not _split(spec):
        return _dequantized(xs)
    outs = [torch.empty_like(x) for x in xs]
    for coord in _block_owners(spec, mesh):
        got = _dequantized([block(x, spec, mesh, coord) for x in xs])
        for o, g in zip(outs, got):
            block(o, spec, mesh, coord).copy_(g)
    return outs


def _axis_mean(named, names, spec, mesh, axis: str, compress: bool):
    """The mean over ``axis`` of the leaves ``names`` sent as one leaf:
    {name: result}, the bytes recorded in ``WIRE``."""
    n = mesh.shape[axis]
    xs = [named[k] for k in names]
    if axis in _split(spec):        # the blocks differ: the general form
        fn = compressed_pmean_blocks if compress else pmean_blocks
        return {k: assemble(fn({c: block(x, spec, mesh, c)
                                for c in positions(mesh)}, mesh, axis),
                            spec, mesh, x) for k, x in zip(names, xs)}
    parts = math.prod(mesh.shape[a] for a in _split(spec))
    numel = sum(x.numel() for x in xs) // parts
    if not compress:
        WIRE.log(axis, "all_reduce", n, numel * xs[0].element_size())
        return dict(zip(names, xs))
    WIRE.log(axis, "all_gather", n, numel)                # int8 payload
    WIRE.log(axis, "all_gather", n, 4)                    # fp32 scale
    return dict(zip(names, _int8_leaf(xs, spec, mesh)))


def grad_sync(grads, mesh, *, pod_wire: bool = True, compress: bool = False,
              pspecs=None, stacks=None, data_axis: str = "data",
              pod_axis: str = "pod", blocks: bool = False):
    """The whole per-step gradient reduction as one region, on a global
    tree of gradients of the whole batch.

    In-pod: a mean over ``data_axis`` for every leaf that is not itself
    ``data``-sharded (an FSDP leaf is already reduced and scattered); on
    these gradients the identity, owned and priced. Cross-pod: when
    ``pod_wire`` the pod mean rides in the same region, over the int8 wire
    when ``compress`` (each block quantised with its own scale: a leaf
    that its spec splits over ``model`` has one a block); when False the
    region has no pod collective.

    ``stacks`` (a name -> (path, index) function) sends the leaves that
    the JAX package stacks over the layer groups as one leaf, so that the
    int8 wire takes one scale a stacked block, as the JAX region does.

    ``blocks``: the tree holds one position's blocks (the dry-run's trace
    of that position), not global tensors; each leaf's spec then only says
    which axes its mean runs over, and the region runs on the blocks as
    one position's program runs it."""
    if mesh is None:
        return grads
    have_data = data_axis in mesh.shape
    have_pod = pod_wire and pod_axis in mesh.shape
    if not (have_data or have_pod):
        return grads
    named = dict(_leaves(grads))
    specs = _spec_table(grads, pspecs)
    out = dict(named)
    for names in _wire_leaves(named, stacks):
        spec = specs[names[0]]
        wire_spec = () if blocks else spec
        if have_data and data_axis not in _split(spec):
            out.update(_axis_mean(out, names, wire_spec, mesh, data_axis,
                                  False))
        if have_pod:
            out.update(_axis_mean(out, names, wire_spec, mesh, pod_axis,
                                  compress))
    return _rebuild(grads, out)


def pod_sync_params(params, mesh, *, compress: bool = False, pspecs=None,
                    axis: str = "pod", blocks: bool = False):
    """``params`` (a global tree of tensors) averaged over the ``axis``
    positions. Every pod holds the same parameters, so the full-precision
    mean is ``params`` themselves, recorded; ``compress`` returns what the
    int8 wire delivers of them, one scale a block. Returns a tree.
    ``blocks``: ``params`` are one position's blocks (``grad_sync``)."""
    if mesh is None or axis not in mesh.shape:
        return params
    named = dict(_leaves(params))
    specs = _spec_table(params, pspecs)
    out = {}
    for name in named:
        out.update(_axis_mean(named, [name], () if blocks else specs[name],
                              mesh, axis, compress))
    return _rebuild(params, out)
