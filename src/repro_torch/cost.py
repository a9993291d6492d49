"""The counting mode: what one program would make the card do, op by op.

``CountingMode`` is a ``TorchDispatchMode``. Around a program it records,
for every aten op that program dispatches (the backward's and a
checkpoint's recomputation included, since the mode sits below autograd):

* FLOPs, counted as XLA's ``HloCostAnalysis`` counts them, so that the
  port's trace and the JAX package's compiled cells count one quantity: a
  product (``mm``, ``bmm``, a convolution, ...) 2·M·N·K from
  ``torch.utils.flop_counter``'s formulas; an elementwise op one a
  produced element (a SiLU four, a softplus six, as XLA's CPU count of
  their expansions); a reduction one an element it reads beyond the first
  of each output; a dtype conversion one an element. Transcendentals
  (exp, log, tanh, sqrt, rsqrt, sin, cos, a sigmoid, a non-integer power)
  are kept apart, as XLA keeps them, and add no FLOPs. An op outside
  these rules (a sort, a gather) counts no FLOPs; ``uncounted`` lists
  them.
* Bytes accessed: each input read once and each output written once, an
  input at the size of the memory its strides reach (an expanded operand
  at its own size). A view (``view``, ``reshape`` without a copy,
  ``transpose``, ``slice``, ``expand``, ``split``) moves nothing; an
  allocation (``empty``) writes nothing, a fill writes its output; a gather
  (``index``, ``embedding``, ``index_select``, ``gather``) reads its rows
  and indices, not its whole source; an indexed write in place
  (``index_copy_``, ``index_put_``, ``scatter_``, ``index_add_``) touches
  the rows it writes (read and written for an accumulation), not the
  whole destination; ``copy_`` reads its source and writes its
  destination. This is eager PyTorch's real traffic: the port's step, and
  the CUDA graph that replays it, fuse nothing.
* The peak of live bytes: the storages the program allocates (a view
  shares its base's), each rounded up to the 512 bytes the CUDA caching
  allocator hands out, from allocation to the death of the storage.
  Tensors made before the mode (the program's arguments) are not counted.
* Kernel records: a hand-written kernel runs through ctypes, which the
  dispatch mode cannot see, so its wrapper enters the kernel's own work
  (``kernel``: name, design, FLOPs, bytes, from the ``work`` function in
  the kernel's module) whenever a mode is active, on the card and on
  ``meta`` tensors alike. Their FLOPs and bytes join the totals.
* Collective records (``collective``): an owned collective of
  ``dist.collectives`` (through ``WIRE``) and a collective GSPMD would
  insert (``dist.implied``), each with the JAX package's HLO kind and
  payload, the mesh axis and its size, and the bytes a position sends.

Ops whose tensors all lie on the CPU are host work and are not counted,
nor is a copy from the host (a transfer, not the device's memory traffic;
the port makes such copies once, for constants it then caches, so
counting them would make a count depend on what ran before); a CPU scalar
beside device tensors adds no bytes.
"""
from __future__ import annotations

import collections
import weakref
from typing import Dict, List, NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

aten = torch.ops.aten

ALLOC_ROUND = 512     # the CUDA caching allocator's smallest block

# the active modes, innermost last (``kernel`` and ``collective`` record
# into the innermost)
_STACK: List["CountingMode"] = []


class KernelRecord(NamedTuple):
    name: str
    design: str
    flops: float
    bytes: float


class CollectiveRecord(NamedTuple):
    kind: str          # the JAX package's HLO name: "all-reduce", ...
    payload: float     # bytes, as the JAX package's HLO parser takes them
    axis: str
    n: int             # positions along the axis
    wire: float        # bytes a position sends (``collectives.Wire``'s rule)
    source: str        # "owned" or "implied"


def active() -> bool:
    return bool(_STACK)


def kernel(name: str, design: str, flops: float, nbytes: float) -> None:
    """Enter one launch of a hand-written kernel into the innermost
    counting mode (nothing when none is active)."""
    if _STACK:
        _STACK[-1].kernels.append(KernelRecord(name, design, float(flops),
                                               float(nbytes)))


def collective(kind: str, payload: float, axis: str, n: int, wire: float,
               source: str) -> None:
    """Enter one collective into the innermost counting mode."""
    if _STACK:
        _STACK[-1].collectives.append(CollectiveRecord(
            kind, float(payload), axis, int(n), float(wire), source))


# ---------------------------------------------------------------- op rules --

_TRANSCENDENTAL = {
    aten.exp, aten.exp2, aten.expm1, aten.log, aten.log1p, aten.log2,
    aten.tanh, aten.sigmoid, aten.sin, aten.cos, aten.sqrt, aten.rsqrt,
    aten.erf, aten.atan2, aten.tan, aten.reciprocal,
}
# composite ops that XLA sees as a few elementwise ops: (FLOPs,
# transcendentals) an output element
_COMPOSITE = {
    aten.silu: (4, 1),                     # x * logistic(x), as XLA's CPU
    aten.silu_backward: (6, 1),            # cost analysis counts them
    aten.softplus: (6, 2),                 # logaddexp(x, 0)
    aten.softplus_backward: (4, 1),
    aten._softmax: (4, 1),                 # max, sub, exp, sum, div
    aten._log_softmax: (4, 1),
    aten._softmax_backward_data: (4, 0),
    aten._log_softmax_backward_data: (3, 1),
    aten.tanh_backward: (2, 0),
    aten.sigmoid_backward: (2, 0),
    aten.threshold_backward: (1, 0),
    aten.sgn: (1, 0),
}
_REDUCTIONS = {
    aten.sum, aten.mean, aten.amax, aten.amin, aten.max, aten.min,
    aten.argmax, aten.argmin, aten.prod, aten.cumsum, aten.logsumexp,
    aten.var, aten.std, aten.norm, aten.linalg_vector_norm, aten.all,
    aten.any,
}
_GATHERS = {aten.index, aten.embedding, aten.index_select, aten.gather}
# in-place indexed writes: (source argument index, index argument indices,
# accumulates)
_SCATTERS = {
    aten.index_copy_: (3, (2,), False), aten.index_copy: (3, (2,), False),
    aten.index_put_: (2, (1,), False), aten.index_put: (2, (1,), False),
    aten._index_put_impl_: (2, (1,), False),
    aten.scatter_: (3, (2,), False), aten.scatter: (3, (2,), False),
    aten.scatter_add_: (3, (2,), True), aten.scatter_add: (3, (2,), True),
    aten.index_add_: (3, (2,), True), aten.index_add: (3, (2,), True),
}
_ALLOCS = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
           aten.new_empty_strided}
_NO_FLOPS = {aten.copy_, aten.clone, aten.cat, aten.stack,
             aten.constant_pad_nd, aten.repeat, aten.zeros, aten.ones, aten.full, aten.zeros_like,
             aten.ones_like, aten.full_like, aten.fill_, aten.zero_,
             aten.new_zeros, aten.new_ones, aten.new_full, aten.arange,
             aten.lift_fresh, aten.lift_fresh_copy, aten.alias,
             aten.detach, aten._unsafe_view, aten.unfold, aten.flip,
             aten.roll, aten.unbind, aten.split, aten.split_with_sizes,
             aten.select_backward, aten.slice_backward,
             aten.scalar_tensor}
# integer elementwise ops without the pointwise tag: one an element
_INT_POINTWISE = {aten.floor_divide, aten.remainder, aten.bitwise_and,
                  aten.bitwise_or}
# backward ops that sum their gradient into a tensor: one FLOP an element
# of the gradient
_SUMS = {aten.unfold_backward, aten.embedding_dense_backward}


def _mm(a, b) -> float:
    return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]


def _bmm(a, b) -> float:
    return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]


# 2·M·N·K of the products (``torch.utils.flop_counter``'s formulas; a bias
# added by ``addmm`` / ``baddbmm`` counts nothing, as there)
_PRODUCTS = {aten.mm: lambda a: _mm(a[0], a[1]),
             aten.addmm: lambda a: _mm(a[1], a[2]),
             aten.bmm: lambda a: _bmm(a[0], a[1]),
             aten.baddbmm: lambda a: _bmm(a[1], a[2])}


def _conv_registry():
    """``torch.utils.flop_counter``'s formulas for the other products
    (convolutions, attention): imported on first use, as the import
    takes seconds."""
    global _CONV
    if _CONV is None:
        from torch.utils.flop_counter import flop_registry
        _CONV = {k: v for k, v in flop_registry.items()
                 if k not in _PRODUCTS}
    return _CONV


_CONV = None


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _extent_bytes(t: torch.Tensor) -> int:
    """The memory ``t``'s strides reach: a broadcast operand at its own
    size, any other view at its elements'."""
    if t.numel() == 0:
        return 0
    extent = 1 + sum((s - 1) * abs(st) for s, st in zip(t.shape, t.stride()))
    return min(t.numel(), extent) * t.element_size()


def _on_host(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def _accumulates(packet, args, kwargs) -> bool:
    flat = list(args) + list(kwargs.values())
    if packet in (aten.index_put_, aten.index_put, aten._index_put_impl_):
        return len(flat) > 3 and bool(flat[3])
    return _SCATTERS[packet][2]


def _from_host(func, args) -> bool:
    """A copy whose source lies on the CPU."""
    packet = func.overloadpacket
    src = args[0] if packet is aten._to_copy else (
        args[1] if packet is aten.copy_ else None)
    return isinstance(src, torch.Tensor) and _on_host(src)


def _int_power(args) -> bool:
    exp = args[1] if len(args) > 1 else None
    return isinstance(exp, (int, float)) and float(exp).is_integer()


def op_cost(func, args, kwargs, out):
    """(FLOPs, transcendentals, bytes, counted) of one op on its inputs and
    outputs; ``counted`` is False where the rules give it no FLOPs for
    want of a rule (see the module docstring)."""
    packet = func.overloadpacket
    ins = [t for t in _tensors((args, kwargs)) if not _on_host(t)]
    outs = [t for t in _tensors(out) if not _on_host(t)]
    in_st = {id(t.untyped_storage()) for t in ins}
    is_view = func.is_view or packet in (aten._unsafe_view, aten.alias,
                                         aten.detach) or (
        outs and not func._schema.is_mutable
        and all(id(t.untyped_storage()) in in_st for t in outs))
    if is_view:
        return 0.0, 0.0, 0.0, True
    n_out = sum(t.numel() for t in outs)
    # bytes
    if packet in _ALLOCS:
        nbytes = 0
    elif packet in _GATHERS:
        idx = [t for t in ins[1:]] if packet != aten.embedding else ins[1:2]
        nbytes = sum(_extent_bytes(t) for t in idx) \
            + 2 * sum(_nbytes(t) for t in outs)
    elif packet in _SCATTERS:
        src_i, idx_i, _ = _SCATTERS[packet]
        acc = _accumulates(packet, args, kwargs)
        flat = list(args) + list(kwargs.values())
        src = flat[src_i] if src_i < len(flat) else None
        idx = [flat[i] for i in idx_i if i < len(flat)]
        src_b = _extent_bytes(src) if isinstance(src, torch.Tensor) else 0
        nbytes = src_b * (3 if acc else 2) + sum(
            _extent_bytes(t) for t in _tensors(idx))
    elif packet is aten.copy_:
        nbytes = _extent_bytes(args[1]) if not _on_host(args[1]) else 0
        nbytes += _nbytes(args[0])
    elif packet in (aten.fill_, aten.zero_, aten.zeros, aten.ones,
                    aten.full, aten.zeros_like, aten.ones_like,
                    aten.full_like, aten.new_zeros, aten.new_ones,
                    aten.new_full, aten.arange):
        nbytes = sum(_nbytes(t) for t in outs)
    else:
        nbytes = sum(_extent_bytes(t) for t in ins) \
            + sum(_nbytes(t) for t in outs)
    # operations
    counted = True
    flops = trans = 0.0
    if packet in _PRODUCTS:
        flops = _PRODUCTS[packet](args)
    elif packet in _conv_registry():
        flops = float(_conv_registry()[packet](*args, **kwargs, out_val=out))
    elif packet in _COMPOSITE:
        f, tr = _COMPOSITE[packet]
        flops, trans = f * n_out, tr * n_out
    elif packet is aten.pow:
        if _int_power(args):
            flops = n_out
        else:
            trans = n_out
    elif packet in _TRANSCENDENTAL:
        trans = n_out
    elif packet in _REDUCTIONS:
        # XLA's count of a reduction: one an input element beyond the first
        # of each output element
        flops = float(max(ins[0].numel() - n_out, 0)) if ins else 0.0
        if packet is aten.mean:
            flops += n_out
    elif packet in _SUMS:
        flops = float(ins[0].numel()) if ins else 0.0
    elif packet in (aten._to_copy, aten.copy_):
        src = args[1] if packet is aten.copy_ else args[0]
        dst_dtype = (args[0].dtype if packet is aten.copy_ else
                     kwargs.get("dtype") or src.dtype)
        flops = n_out if dst_dtype != src.dtype else 0.0
    elif packet in _SCATTERS and nbytes and _accumulates(packet, args,
                                                        kwargs):
        src = (list(args) + list(kwargs.values()))[_SCATTERS[packet][0]]
        flops = float(src.numel())
    elif packet in _NO_FLOPS or packet in _ALLOCS or packet in _GATHERS \
            or packet in _SCATTERS:
        pass
    elif torch.Tag.pointwise in func.tags or packet in _INT_POINTWISE:
        flops = n_out
    else:
        counted = False
    return flops, trans, float(nbytes), counted


# ----------------------------------------------------------------- the mode --

class CountingMode(TorchDispatchMode):
    """Counts the ops of the program run inside it (see the module
    docstring). After it exits: ``flops``, ``transcendentals``,
    ``bytes_accessed`` (kernels included), ``peak_bytes`` (of the storages
    allocated inside), ``by_op`` ({op: [calls, FLOPs, bytes]}),
    ``kernels`` and ``collectives`` (lists of records), ``uncounted``
    (ops without a FLOP rule, by name)."""

    def __init__(self):
        super().__init__()
        self.by_op: Dict[str, List[float]] = collections.defaultdict(
            lambda: [0, 0.0, 0.0])
        self.op_flops = self.op_bytes = self.transcendentals = 0.0
        self.kernels: List[KernelRecord] = []
        self.collectives: List[CollectiveRecord] = []
        self.uncounted: Dict[str, int] = collections.Counter()
        self.live = self.peak_bytes = 0
        self._seen: Dict[int, int] = {}

    def __enter__(self):
        _STACK.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _STACK.remove(self)
        return super().__exit__(*exc)

    @property
    def flops(self) -> float:
        return self.op_flops + sum(k.flops for k in self.kernels)

    @property
    def bytes_accessed(self) -> float:
        return self.op_bytes + sum(k.bytes for k in self.kernels)

    def _free(self, key: int, nbytes: int) -> None:
        self._seen.pop(key, None)
        self.live -= nbytes

    def _track(self, tensors, new: bool) -> None:
        for t in tensors:
            st = t.untyped_storage()
            key = id(st)
            if key in self._seen:
                continue
            nbytes = -(-st.nbytes() // ALLOC_ROUND) * ALLOC_ROUND if new \
                else 0
            self._seen[key] = nbytes
            self.live += nbytes
            weakref.finalize(st, self._free, key, nbytes)
        self.peak_bytes = max(self.peak_bytes, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = [t for t in _tensors((args, kwargs)) if not _on_host(t)]
        self._track(ins, new=False)         # arguments made outside
        out = func(*args, **kwargs)
        outs = [t for t in _tensors(out) if not _on_host(t)]
        if not ins and not outs or _from_host(func, args):
            return out                      # host work
        self._track(outs, new=True)
        flops, trans, nbytes, counted = op_cost(func, args, kwargs, out)
        name = str(func.overloadpacket.__name__)
        rec = self.by_op[name]
        rec[0] += 1
        rec[1] += flops
        rec[2] += nbytes
        self.op_flops += flops
        self.transcendentals += trans
        self.op_bytes += nbytes
        if not counted:
            self.uncounted[name] += 1
        return out

    # ------------------------------------------------------------ summaries

    def top_ops(self, key: str = "bytes", n: int = 10):
        """The ``n`` ops with the most bytes (or FLOPs), kernels included:
        [{op, calls, flops, bytes}]."""
        rows = {k: list(v) for k, v in self.by_op.items()}
        for k in self.kernels:
            r = rows.setdefault(f"kernel:{k.name}[{k.design}]", [0, 0.0, 0.0])
            r[0] += 1
            r[1] += k.flops
            r[2] += k.bytes
        i = 2 if key == "bytes" else 1
        top = sorted(rows.items(), key=lambda kv: -kv[1][i])[:n]
        return [dict(op=k, calls=int(v[0]), flops=v[1], bytes=v[2])
                for k, v in top]

    def kernel_summary(self) -> Dict[str, Dict[str, float]]:
        """{"name[design]": {launches, flops, bytes}}."""
        out: Dict[str, Dict[str, float]] = {}
        for k in self.kernels:
            r = out.setdefault(f"{k.name}[{k.design}]",
                               dict(launches=0, flops=0.0, bytes=0.0))
            r["launches"] += 1
            r["flops"] += k.flops
            r["bytes"] += k.bytes
        return out


def storage_bytes(tensors) -> int:
    """Bytes of the distinct storages under ``tensors`` (a view counts its
    base once)."""
    seen, n = set(), 0
    for t in tensors:
        st = t.untyped_storage()
        if id(st) not in seen:
            seen.add(id(st))
            n += st.nbytes()
    return n
