"""Checkpointing with atomic and async writes, retention, a preemption hook
and a restore that skips torn checkpoints. Counterpart of the JAX
package's ``ckpt/checkpoint.py`` on one device, in its on-disk format, so
a checkpoint written by either package restores into the other.

Layout: a directory ``step_<n>`` holding ``shard0.npz`` (the leaves as
``a0``, ``a1``, ...) and ``manifest.json`` (``step``, ``n_leaves``,
``treedef``, ``dtypes``, ``shapes``, ``mesh``, ``time``, ``extra``). The
leaves are laid out in ``jax.tree.flatten`` order: dict keys sorted,
tuples and lists in order, depth first. A training state is the tuple
``(params, opt)``: the parameters in the JAX package's nesting
(``convert.tree_to_numpy``: layers stacked over their groups) and
``OptState(step, m, v)``, ``step`` an int32 scalar and the moments nested
as the parameters. ``save`` and ``restore`` take such a tree of numpy
arrays or tensors; ``state_tree``, ``state_like`` and ``load_state``
carry the port's ``(ParamTree, OptState)`` across, and
``CheckpointManager`` (periodic async saves, retention, the SIGTERM hook,
the restore that skips a torn checkpoint) writes and reads them.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import signal
import sys
import tempfile
import threading
import time
import zipfile
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.convert import jax_path, named_from_numpy, tree_to_numpy
from repro_torch.train import optim

# everything a truncated/partial checkpoint (a kill mid-write, a torn copy)
# can raise on load: bad manifest JSON, torn npz central directory, missing
# arrays, shape/leaf-count drift, vanished files
CORRUPT_ERRORS = (json.JSONDecodeError, zipfile.BadZipFile, KeyError,
                  AssertionError, ValueError, EOFError, OSError)


def flatten(tree) -> List:
    """The leaves of a nested dict / tuple / list tree in
    ``jax.tree.flatten`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flatten(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in flatten(t)]
    return [tree]


def _map(fn, tree):
    """``fn`` over the leaves of a nested dict / tuple / list tree, in
    ``flatten`` order; named tuples keep their type."""
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        vals = [_map(fn, t) for t in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") \
            else type(tree)(vals)
    return fn(tree)


def unflatten(like, leaves):
    """``like``'s structure with its leaves replaced, in ``flatten``
    order."""
    it = iter(leaves)
    return _map(lambda _: next(it), like)


def treedef(tree) -> str:
    """A description of the tree's nesting (the manifest's ``treedef``)."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {treedef(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (tuple, list)):
        name = type(tree).__name__
        return f"{name}(" + ", ".join(treedef(t) for t in tree) + ")"
    return "*"


def _host(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _host_copy(x) -> np.ndarray:
    """``x`` in host memory of its own: a CPU tensor's ``numpy()`` is a
    view, which an in-place update after an async save would reach."""
    if torch.is_tensor(x):
        return x.detach().to("cpu", copy=True).numpy()
    return np.array(x, copy=True)


def save(path, tree, step: int, *, extra: Optional[Dict] = None) -> None:
    """Atomic (write-then-rename) checkpoint save of a tree of numpy arrays
    or tensors."""
    path = pathlib.Path(path)
    tmp = pathlib.Path(tempfile.mkdtemp(
        dir=path.parent if path.parent.exists() else None,
        prefix=".ckpt_tmp_"))
    arrays = {f"a{i}": _host(x) for i, x in enumerate(flatten(tree))}
    np.savez(tmp / "shard0.npz", **arrays)
    manifest = {
        "step": int(step),
        "n_leaves": len(arrays),
        "treedef": treedef(tree),
        "dtypes": [str(x.dtype) for x in arrays.values()],
        "shapes": [list(x.shape) for x in arrays.values()],
        "mesh": None,
        "time": time.time(),
        "extra": extra or {},
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if path.exists():
        shutil.rmtree(path)
    os.replace(tmp, path)


def restore(path, like_tree):
    """The checkpoint at ``path`` in the structure of ``like_tree``, whose
    leaves need only a ``shape``; the leaf count and every shape must
    match. Returns (tree of numpy arrays, step)."""
    path = pathlib.Path(path)
    manifest = json.loads((path / "manifest.json").read_text())
    leaves = flatten(like_tree)
    assert len(leaves) == manifest["n_leaves"], "tree structure changed"
    data = np.load(path / "shard0.npz")
    out = []
    for i, ref in enumerate(leaves):
        arr = data[f"a{i}"]
        assert tuple(arr.shape) == tuple(ref.shape), \
            (i, arr.shape, ref.shape)
        out.append(arr)
    return unflatten(like_tree, out), manifest["step"]


def latest_step(root) -> Optional[int]:
    root = pathlib.Path(root)
    if not root.exists():
        return None
    steps = [int(p.name.split("_")[-1]) for p in root.glob("step_*")
             if (p / "manifest.json").exists()]
    return max(steps) if steps else None


def all_steps(root) -> List[int]:
    """Every step directory present (descending), manifest or not: the
    corruption-tolerant restore scans these newest-first."""
    root = pathlib.Path(root)
    if not root.exists():
        return []
    steps = []
    for p in root.glob("step_*"):
        try:
            steps.append(int(p.name.split("_")[-1]))
        except ValueError:
            continue
    return sorted(steps, reverse=True)


# ------------------------------------------------- the port's train state --

class LeafShape:
    """A restore target's leaf: its shape only."""
    __slots__ = ("shape",)

    def __init__(self, shape: Tuple[int, ...]):
        self.shape = tuple(shape)


def state_tree(state, cfg):
    """The port's ``(params, opt)`` as the JAX package's train state in
    numpy (the synchronous host copy of a save): ``(params, OptState(step,
    m, v))`` nested as ``convert.tree_to_numpy`` lays the parameters out,
    ``step`` an int32 scalar."""
    params, opt = state
    return (tree_to_numpy(dict(params.named_parameters()), cfg),
            optim.OptState(np.asarray(opt.step, np.int32),
                           tree_to_numpy(opt.m, cfg),
                           tree_to_numpy(opt.v, cfg)))


def state_like(state, cfg):
    """``state_tree``'s structure with ``LeafShape`` leaves (a restore
    target; nothing is copied)."""
    params, _ = state

    def shapes():
        out = {}
        for name, t in params.named_parameters():
            path, i = jax_path(name, cfg)
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            if i is None:
                node[path[-1]] = LeafShape(tuple(t.shape))
            else:
                n = node[path[-1]].shape[0] + 1 if path[-1] in node else 1
                node[path[-1]] = LeafShape((n,) + tuple(t.shape))
        return out
    return (shapes(), optim.OptState(LeafShape(()), shapes(), shapes()))


def load_state(tree, state, cfg):
    """Copy a ``state_tree``-shaped tree of arrays (a restore's result)
    into the port's ``(params, opt)``, in place. Returns (params, opt)."""
    (p_np, o_np), (params, opt) = tree, state
    named = dict(params.named_parameters())
    with torch.no_grad():
        for src, dst in ((p_np, named), (o_np.m, opt.m), (o_np.v, opt.v)):
            for name, a in named_from_numpy(src, dst, cfg).items():
                dst[name].copy_(torch.from_numpy(a))
    return params, optim.OptState(int(o_np.step), opt.m, opt.v)


class CheckpointManager:
    """Periodic + async checkpointing with retention and a preemption hook.

    ``save_async`` copies the tree to host memory synchronously (``to_host``:
    ``state_tree`` for the port's train state; by default each leaf to a
    numpy array of its own) and writes it to disk on a background thread,
    so the train loop never waits for storage. ``save_sync`` writes at once, after any write
    in flight, and skips a step this manager has just written (the final
    save of a run whose last step was a period's). SIGTERM (preemption),
    when ``install_sigterm``, triggers a final synchronous save."""

    def __init__(self, root, *, period: int = 100, keep: int = 3,
                 install_sigterm: bool = False,
                 to_host: Optional[Callable] = None):
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.period = period
        self.keep = keep
        self.to_host = to_host or (lambda tree: _map(_host_copy, tree))
        self._thread: Optional[threading.Thread] = None
        self._last_tree = None
        self._last_step = None
        self._written: Optional[int] = None
        # corrupt checkpoints skipped on restore (the warning's audit trail)
        self.skipped: List[str] = []
        # seconds of each save's host copy and write, and of each restore
        self.timings: List[Dict] = []
        # a kill mid-``save`` leaves the stage dir behind (the rename never
        # ran, so the checkpoint set itself is intact): sweep stale stages
        for tmp in self.root.glob(".ckpt_tmp_*"):
            shutil.rmtree(tmp, ignore_errors=True)
        if install_sigterm:
            signal.signal(signal.SIGTERM, self._on_sigterm)

    def _on_sigterm(self, signum, frame):   # pragma: no cover - signal path
        if self._last_tree is not None:
            self.save_sync(self._last_tree, self._last_step)
        raise SystemExit(143)

    def maybe_save(self, tree, step: int) -> bool:
        self._last_tree, self._last_step = tree, step
        if step % self.period != 0:
            return False
        self.save_async(tree, step)
        return True

    def save_async(self, tree, step: int) -> None:
        t = time.perf_counter()
        host_tree = self.to_host(tree)
        host_s = time.perf_counter() - t
        self.wait()
        self._written = step
        self._thread = threading.Thread(
            target=self._write, args=(host_tree, step, host_s), daemon=True)
        self._thread.start()

    def save_sync(self, tree, step: int) -> None:
        self.wait()
        if step == self._written:
            return
        self._written = step
        t = time.perf_counter()
        host_tree = self.to_host(tree)
        self._write(host_tree, step, time.perf_counter() - t)

    def _write(self, tree, step: int, host_s: float) -> None:
        t = time.perf_counter()
        save(self.root / f"step_{step}", tree, step)
        self._gc()
        self.timings.append(dict(step=step, host_s=host_s,
                                 write_s=time.perf_counter() - t))

    def _gc(self) -> None:
        steps = sorted(int(p.name.split("_")[-1])
                       for p in self.root.glob("step_*"))
        for s in steps[: -self.keep]:
            shutil.rmtree(self.root / f"step_{s}", ignore_errors=True)

    def wait(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()

    def restore_latest(self, like_tree):
        """Restore the newest loadable checkpoint, scanning steps newest
        first and skipping, with a warning, any that a kill or a torn copy
        left truncated or partial (bad manifest JSON, torn npz, missing
        arrays, shape or leaf-count drift); skipped paths are recorded on
        ``self.skipped``. Returns (tree, step), or (None, None)."""
        for step in all_steps(self.root):
            path = self.root / f"step_{step}"
            t = time.perf_counter()
            try:
                out = restore(path, like_tree)
                self.timings.append(dict(step=step, restore_s=(
                    time.perf_counter() - t)))
                return out
            except CORRUPT_ERRORS as e:
                self.skipped.append(str(path))
                print(f"WARNING: skipping corrupt/partial checkpoint {path} "
                      f"({type(e).__name__}: {e}) — falling back to an "
                      "older step", file=sys.stderr)
        return None, None
