"""Capacity events, deterministic fault injection and live re-homing.
Counterpart of the JAX package's ``dist/elastic.py``.

The harshest resource pressure a serving fleet meets is capacity
revocation: preempted devices, transient servers reclaimed with a deadline,
a co-tenant's emergency quota grab, a flaky interconnect failing a
collective. This module is the substrate that lets a driver script those
events and survive them:

* ``CapacityEvent``: one revocation / restore / quota / collective
  incident, with an optional grace ``deadline_steps`` (the victim keeps
  the capacity for that many steps and must be off it by the end).
* ``FaultInjector``: a deterministic, seedable event schedule keyed by the
  driver's step counter; the same script under the same seed gives the same
  faults, so a chaos run can be held token for token to an unfaulted one.
* ``pick_revoked`` / ``surviving_mesh``: which positions a count-only
  revocation takes, and the largest rectangular mesh over the survivors
  (model axes pinned, batch axes shrunk outermost first). They take the
  port's ``launch.mesh.Mesh``, whose positions carry ordinal ``ids``.
* ``host_stage`` / ``reshard_live``: a tree of tensors copied to the host
  and back onto a device, the checkpoint-restore path without the disk.

Kinds: ``REVOKE`` (``count`` positions, or the explicit ``devices`` ids,
leave at ``step + deadline_steps``), ``RESTORE`` (revoked positions return;
all of them when ``devices`` is empty), ``QUOTA_CUT`` / ``QUOTA_RESTORE``
(a hard capacity floor of ``quanta`` pool quanta, separate from the Pliant
reclaim ledger) and ``COLLECTIVE_FAILURE`` (``count`` transient step
failures: the engine discards the failed step's results and re-runs it).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

REVOKE = "revoke"
RESTORE = "restore"
QUOTA_CUT = "quota_cut"
QUOTA_RESTORE = "quota_restore"
COLLECTIVE_FAILURE = "collective_failure"

KINDS = (REVOKE, RESTORE, QUOTA_CUT, QUOTA_RESTORE, COLLECTIVE_FAILURE)

# kinds that take capacity OUT (pressure on) vs give it BACK (pressure off)
PRESSURE_ON = (REVOKE, QUOTA_CUT)
PRESSURE_OFF = (RESTORE, QUOTA_RESTORE)


@dataclass(frozen=True)
class CapacityEvent:
    """One scripted capacity incident, keyed by the driver's step counter."""
    kind: str
    step: int                          # driver step at which the notice lands
    count: int = 0                     # positions to revoke / failures
    devices: Tuple[int, ...] = ()      # explicit position ids (over count)
    quanta: int = 0                    # pool-quanta size of a quota cut
    deadline_steps: int = 0            # grace: revocation effective at
                                       # step + deadline_steps (0 = at once)

    def __post_init__(self):
        assert self.kind in KINDS, self.kind
        assert self.step >= 0 and self.deadline_steps >= 0, self


class FaultInjector:
    """Deterministic, seedable capacity-event schedule.

    Drivers poll ``due(step)`` once a loop iteration; every event whose
    ``step`` has arrived is handed back exactly once, in (step, schedule
    order). ``parse`` reads the compact CLI grammar of ``--chaos``::

        revoke@20:2        revoke 2 positions at step 20 (immediate)
        revoke@20+5:2      same, with a 5-step grace deadline
        restore@60         restore every revoked position at step 60
        quota_cut@10:3     cut 3 pool quanta at step 10
        quota_restore@40   lift the quota cut
        fail@15:2          2 transient collective failures from step 15

    ``random_script`` derives a reproducible paired revoke/restore schedule
    from a seed (numpy's generator, so it draws the JAX package's events).
    """

    def __init__(self, events: Sequence[CapacityEvent] = ()):
        self._events: List[CapacityEvent] = []
        self._seq: List[int] = []      # schedule order (stable tie-break)
        self.delivered: List[CapacityEvent] = []
        for ev in events:
            self.schedule(ev)

    def schedule(self, ev: CapacityEvent) -> None:
        self._events.append(ev)
        self._seq.append(len(self._seq))

    def pending(self) -> int:
        return len(self._events)

    def due(self, step: int) -> List[CapacityEvent]:
        """Pop (in schedule-stable step order) every event now due."""
        take = sorted((i for i, ev in enumerate(self._events)
                       if ev.step <= step),
                      key=lambda i: (self._events[i].step, self._seq[i]))
        out = [self._events[i] for i in take]
        for i in sorted(take, reverse=True):
            del self._events[i]
            del self._seq[i]
        self.delivered.extend(out)
        return out

    _ALIASES = {"fail": COLLECTIVE_FAILURE, **{k: k for k in KINDS}}

    @classmethod
    def parse(cls, script: str) -> "FaultInjector":
        events = []
        for part in filter(None, (p.strip() for p in script.split(","))):
            head, _, arg = part.partition(":")
            kind, _, when = head.partition("@")
            assert kind in cls._ALIASES, f"unknown event kind {kind!r}"
            kind = cls._ALIASES[kind]
            step, _, grace = when.partition("+")
            k = int(arg) if arg else 0
            events.append(CapacityEvent(
                kind, int(step),
                count=k if kind in (REVOKE, COLLECTIVE_FAILURE) else 0,
                quanta=k if kind == QUOTA_CUT else 0,
                deadline_steps=int(grace) if grace else 0))
        return cls(events)

    @classmethod
    def random_script(cls, *, n_rounds: int, max_step: int, n_devices: int,
                      seed: int = 0, deadline_steps: int = 2
                      ) -> "FaultInjector":
        """Seed-deterministic paired revoke/restore rounds: each round
        revokes 1..n_devices//2 positions at a random step and restores
        them at a later one."""
        rng = np.random.default_rng(seed)
        events = []
        slots = sorted(rng.choice(max(max_step, 2 * n_rounds),
                                  size=2 * n_rounds, replace=False))
        for r in range(n_rounds):
            k = int(rng.integers(1, max(n_devices // 2, 1) + 1))
            events.append(CapacityEvent(REVOKE, int(slots[2 * r]), count=k,
                                        deadline_steps=deadline_steps))
            events.append(CapacityEvent(RESTORE, int(slots[2 * r + 1])))
        return cls(events)


# ------------------------------------------------------------ mesh shrink --

# axes that carry batch/sequence work and may shrink under revocation; every
# other axis (``model`` above all) is pinned: weight dims divide it
BATCH_AXES = ("pod", "data")


def pick_revoked(mesh, count: int, already=()) -> Tuple[int, ...]:
    """Position choice for a ``count``-only revocation: the highest ids of
    the mesh not already revoked (the tail of the batch-axis split, so the
    survivors stay a contiguous prefix, as the slot-affinity pool splits)."""
    gone = {int(a) for a in already}
    ids = sorted(i for i in mesh.ids if i not in gone)
    return tuple(ids[len(ids) - count:]) if count else ()


def surviving_mesh(mesh, revoked, *, prefer_divisor_of: int = 0):
    """(new_mesh, reason): the largest rectangular mesh over the surviving
    positions.

    Model-parallel axes keep their size; batch axes shrink, outermost
    first. With ``prefer_divisor_of`` (the engine passes ``batch_slots``) a
    smaller batch-axis size that divides it is preferred over a larger one
    that does not, when it costs at most half: keeping the slot-affinity
    plan beats keeping spare positions busy on the gather fallback. Returns
    ``(None, reason)`` when not even the pinned axes fit the survivors."""
    from repro_torch.launch.mesh import Mesh

    if mesh is None:
        return None, "no mesh to shrink"
    revoked = {int(r) for r in revoked}
    survivors = [i for i in sorted(mesh.ids) if i not in revoked]
    if not revoked:
        return mesh, "nothing revoked"
    axes = list(mesh.shape)
    sizes = {a: int(mesh.shape[a]) for a in axes}
    pinned = math.prod(sizes[a] for a in axes if a not in BATCH_AXES)
    if pinned > len(survivors):
        return None, (f"{len(survivors)} survivors cannot carry the pinned "
                      f"model axes (need {pinned})")
    batch = [a for a in axes if a in BATCH_AXES]
    new_sizes = dict(sizes)
    budget = len(survivors) // pinned      # total batch-axis capacity left
    # shrink the outermost batch axis first; inner ones only if still over
    for ai, a in enumerate(batch):
        inner = math.prod(new_sizes[b] for b in batch[ai + 1:])
        n = min(sizes[a], max(budget // inner, 1))
        if prefer_divisor_of:
            div = max((d for d in range(1, n + 1)
                       if prefer_divisor_of % d == 0), default=1)
            n = div if div * 2 >= n else n
        new_sizes[a] = n
        budget = (len(survivors) // pinned) // math.prod(
            new_sizes[b] for b in batch[:ai + 1])
    need = pinned * math.prod(new_sizes[a] for a in batch)
    assert need <= len(survivors), (new_sizes, len(survivors))
    shape = tuple(new_sizes[a] for a in axes)
    pos = {i: d for i, d in zip(mesh.ids, mesh.devices)}
    keep = survivors[:need]
    reason = (f"{need} of {len(survivors)} survivors as "
              + "x".join(str(s) for s in shape))
    return Mesh(shape, axes, [pos[i] for i in keep], ids=keep), reason


# ----------------------------------------------------------- live reshard --

def _tensors(fn, tree):
    """``fn`` over the tensors of a nested dict / tuple / list tree (named
    tuples keep their type); other leaves pass through."""
    from repro_torch.ckpt.checkpoint import _map
    return _map(lambda x: fn(x) if isinstance(x, torch.Tensor) else x, tree)


def host_stage(tree):
    """Copy every tensor of ``tree`` (dicts, lists, tuples, NamedTuples)
    to host memory: the first half of every elastic move. A copy even for
    a CPU tensor, since the caller's tensors may be updated in place."""
    return _tensors(lambda x: x.detach().to("cpu", copy=True), tree)


def reshard_live(tree, device="cpu"):
    """Host-stage ``tree`` and put it back on ``device``: the
    checkpoint-restore path without the disk round trip. The mesh's
    positions share one device here, so placement is that device."""
    return _tensors(lambda x: x.to(device), host_stage(tree))
