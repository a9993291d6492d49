"""The collectives GSPMD would insert into one position's program, recorded
where they would happen while the dry-run traces that position.

The JAX package's dry-run gets these from the compiler: its partitioner
adds them to the per-device program of a sharded cell, and its HLO carries
them. The port traces one position's program on ``meta`` tensors
(``launch/dryrun.py``), where a config cut to the position's sizes
computes that position's share and nothing moves between positions. So
the model path calls the hooks below at the points where the partitioned
program communicates, and ``tracing(plan)`` makes them record into the
active counting mode (``repro_torch.cost``). With no plan (every run but a
trace) they return their argument and record nothing.

The rule, for a part (``"attn"``, ``"mlp"``, ``"ssm"``, ``"vocab"``) whose
dims the plan splits over the ``model`` axis (megatron's f and g):

* ``row_out``: the output of a product whose contraction runs over the
  split dim (attention's ``wo``, the MLP's ``wo``, Mamba's ``out_proj``;
  the vocab-parallel embedding's gather) is a partial sum: an all-reduce
  of it over ``model`` in the forward (again in a checkpoint's
  recomputation, as XLA's rematerialised forward holds it again);
* ``col_in``: the input of products split on their output dim (``wq``,
  ``wk``, ``wv``; ``wi_gate``, ``wi_up``; ``in_z``, ``in_x``, ``in_dt``;
  the unembedding; the SSD scan's B and C, which every head reads) gets
  partial input gradients: an all-reduce of that gradient in the
  backward;
* ``rows``: a row statistic over a split dim (the vocab-parallel
  cross-entropy's max, sum of exponentials and gold logit; Mamba's gated
  RMS norm over ``ssm_inner``): an all-reduce of the (..., 1) fp32 rows
  in the forward, and with ``backward`` one more in the backward (the
  norm's gradient sums over the dim again);
* ``seq_combine``: a decode step over a cache whose length is split over
  ``model`` (``sharding.cache_shardings``) combines each position's
  softmax partials: all-reduces of the (B, H) max and sum and of the
  (B, H, hd) accumulator, fp32;
* ``gather`` / its backward: a leaf whose storage is split on a dim the
  position computes whole (the FSDP ``embed`` dim over ``data``, heads
  that do not divide ``model``) is all-gathered before use and its
  gradient reduce-scattered (``launch/dryrun.py`` applies it to the
  parameters).

Each record carries the JAX package's HLO kind and payload (an all-reduce
its buffer, an all-gather its gathered result, a reduce-scatter its
input) and the bytes a position sends (``collectives.Wire``'s rule).
"""
from __future__ import annotations

import contextlib
from typing import FrozenSet, NamedTuple, Optional, Tuple

import torch

from repro_torch import cost


class Plan(NamedTuple):
    """What one traced position splits: the ``model`` axis' size, the
    parts whose dims it splits over that axis, the decode cache's
    sequence shards (1: whole), the expert shards over ``model`` (1: no
    expert parallelism; ``models/moe.py`` then runs one position's block
    of its region) and the mesh's (axis, size) pairs."""
    model: int
    split: FrozenSet[str]
    seq: int = 1
    ep: int = 1
    axes: Tuple[Tuple[str, int], ...] = ()


PLAN: Optional[Plan] = None


@contextlib.contextmanager
def tracing(plan: Plan):
    """Record the implied collectives of ``plan`` while the block runs."""
    global PLAN
    prev, PLAN = PLAN, plan
    try:
        yield plan
    finally:
        PLAN = prev


def _wire(kind: str, payload: float, n: int) -> float:
    if kind == "all-reduce":
        return 2.0 * (n - 1) / n * payload
    return (n - 1) / n * payload       # all-gather result / scatter input


def record(kind: str, payload: float, axis: str, n: int) -> None:
    if n > 1:
        cost.collective(kind, payload, axis, n, _wire(kind, payload, n),
                        "implied")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _splits(part: str) -> bool:
    return PLAN is not None and part in PLAN.split and PLAN.model > 1


def row_out(y: torch.Tensor, part: str) -> torch.Tensor:
    if _splits(part):
        record("all-reduce", _nbytes(y), "model", PLAN.model)
    return y


def col_in(x: torch.Tensor, part: str) -> torch.Tensor:
    if _splits(part) and x.requires_grad:
        n = PLAN.model
        x.register_hook(lambda g: record("all-reduce", _nbytes(g), "model",
                                         n))
    return x


def rows(x: torch.Tensor, part: str, count: int = 1,
         backward: bool = False) -> None:
    if _splits(part):
        n = PLAN.model
        per = x.numel() // max(x.shape[-1], 1) * 4
        for _ in range(count):
            record("all-reduce", per, "model", n)
        if backward and x.requires_grad:
            x.register_hook(lambda g: record("all-reduce", per, "model", n))


def seq_combine(batch: int, heads: int, head_dim: int) -> None:
    if PLAN is not None and PLAN.seq > 1:
        for payload in (4 * batch * heads, 4 * batch * heads,
                        4 * batch * heads * head_dim):
            record("all-reduce", payload, "model", PLAN.seq)


class Gather(torch.autograd.Function):
    """A leaf's whole (compute) tensor from the position's block: the
    all-gather over ``axis`` in the forward, the reduce-scatter of the
    gradient back to the block in the backward. On ``meta`` only shapes
    move; the records carry the bytes."""

    @staticmethod
    def forward(ctx, local, shape, axis, n):
        ctx.meta = (tuple(local.shape), axis, n)
        out = local.new_empty(shape)
        record("all-gather", _nbytes(out), axis, n)
        return out

    @staticmethod
    def backward(ctx, g):
        shape, axis, n = ctx.meta
        record("reduce-scatter", _nbytes(g), axis, n)
        return g.new_empty(shape), None, None, None
