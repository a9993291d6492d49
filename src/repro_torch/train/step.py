"""Train and serve step factories, parameterised by ``ApproxKnobs``.
Counterpart of the JAX package's ``train/step.py``: ``make_train_step`` for
every family (over a mesh with the owned gradient-sync region,
``grad_reduce_for``, and expert parallelism, ``ep_axis``), ``pod_sync``
(the ``sync_period`` knob's periodic parameter sync),
``graphed_train_step`` (a train step captured as one CUDA graph, the
counterpart of ``jax.jit``), ``make_serve_step`` (one token against the
caches, the encoder-decoder's with ``enc_out``), ``make_prefill_fn`` (a
full forward's last-token logits), and the serving engine's K-step
megastep (``make_paged_megastep``).

``make_train_step(cfg, knobs, ...)`` returns a ``TrainStep``: forward, the
autograd backward, clipping and the AdamW update, run eagerly, the
schedule scalars read from a device tensor (``optim.schedule_on``).
Gradient accumulation over ``n_micro`` micro-batches splits every leaf of
the batch (``tokens``, ``frames``, ``prefix_embeds``) and sums the
gradients in fp32.

Over a ``mesh`` the forward and backward run unsplit on the one card,
which is numerically what the JAX package's GSPMD program gives for the
batch split and the TP/FSDP params: the gradients arrive reduced over the
whole batch. Then the region of ``dist.collectives.grad_sync`` runs on
them, the JAX package's ``shard_map`` region. Whether it holds the
pod collective is fixed when the step is built, so a ``sync_period > 1``
variant's captured graph holds none, the counterpart of the JAX package
eliding it at trace time. On the card the training driver (``launch/train.py``
``build_variant_steps``) wraps each variant's step in a
``GraphedTrainStep``: the Pliant actuator (``core/variants``) keeps one
per variant and switches which one replays at a step boundary, as the JAX
package switches between compiled executables. On the CPU the table holds
the eager steps.
"""
from __future__ import annotations

import functools
import time
from typing import Dict, Iterable, Optional

import torch

from repro_torch.approx.knobs import PRECISE, ApproxKnobs
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import jax_path
from repro_torch.dist import collectives
from repro_torch.kernels import flash_attention, int8_matmul, quantize_rows
from repro_torch.kernels import ssd_scan
from repro_torch.models import api
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import lm as lm_mod
from repro_torch.train import optim


def grad_reduce_for(knobs: ApproxKnobs, mesh, pspecs=None, stacks=None,
                    blocks: bool = False):
    """The owned gradient-sync region a (knobs, mesh) pair calls for: a
    {name: grad} -> {name: grad} callable running
    ``collectives.grad_sync``, or None when there is nothing to own:

    * single device, or a mesh without data or pod axes: None;
    * a ``data`` axis: the in-pod mean over ``data`` (the identity on
      gradients of the whole batch, but owned and priced);
    * a ``pod`` axis and ``sync_period == 1``: the cross-pod mean in the
      same region, over the int8 wire when ``grad_compress == "int8"``;
    * ``sync_period > 1``: no pod collective in the region; the driver
      runs ``pod_sync`` every k steps instead.

    ``stacks`` (``TrainStep`` passes ``convert.jax_path`` of its config)
    runs the region on the leaves stacked as the JAX package stacks them,
    so the int8 wire's scales are the JAX region's. ``blocks``: the
    gradients are one position's blocks (the dry-run's trace). The
    callable exposes ``.pod_wire`` and ``.compress``."""
    shape = getattr(mesh, "shape", {}) if mesh is not None else {}
    if "data" not in shape and "pod" not in shape:
        return None
    pod_wire = "pod" in shape and knobs.sync_period == 1
    compress = knobs.grad_compress == "int8"

    def reduce_fn(g):
        return collectives.grad_sync(g, mesh, pod_wire=pod_wire,
                                     compress=compress, pspecs=pspecs,
                                     stacks=stacks, blocks=blocks)
    reduce_fn.pod_wire = pod_wire
    reduce_fn.compress = compress
    return reduce_fn


def pod_sync(params, mesh, pspecs=None):
    """Periodic pod-level parameter sync (the ``sync_period`` knob),
    full precision. A no-op without a pod axis, so a driver calls it
    every k steps whatever the mesh. Every pod holds the same parameters
    (the steps' gradients are the whole batch's, which the JAX package's
    GSPMD reduces over the pods before its region), so the mean is the
    parameters themselves: ``collectives.pod_sync_params`` records its
    bytes and ``params`` stay as they are."""
    if mesh is None or "pod" not in getattr(mesh, "shape", {}):
        return params
    collectives.pod_sync_params(dict(params.named_parameters()), mesh,
                                pspecs=pspecs)
    return params


def _micro_split(batch, n_micro: int):
    """A list of ``n_micro`` batches, every leaf cut along its rows."""
    for x in batch.values():
        assert x.shape[0] % n_micro == 0, (x.shape[0], n_micro)
    parts = {k: x.chunk(n_micro) for k, x in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n_micro)]


class TrainStep:
    """One variant's eager train step: ``step(params, opt, batch) ->
    (params, opt, metrics)``, the parameters and moments updated in place.
    ``body`` is the step's device work on given tensors, which
    ``GraphedTrainStep`` captures. ``gather``, None unless the dry-run
    traces one position, maps the parameters a position holds to the
    tensors its forward reads (``launch/dryrun.py``: the all-gathered
    leaves); the gradients are taken with respect to the parameters."""

    def __init__(self, cfg: ModelConfig, knobs: ApproxKnobs,
                 opt_cfg: optim.OptConfig, n_micro: int, remat: str,
                 ep_axis: Optional[str] = None, mesh=None,
                 param_pspecs=None):
        self.cfg, self.knobs, self.opt_cfg = cfg, knobs, opt_cfg
        self.n_micro, self.remat = n_micro, remat
        self.ep_axis, self.mesh = ep_axis, mesh
        self.grad_reduce = grad_reduce_for(
            knobs, mesh, param_pspecs,
            stacks=functools.partial(jax_path, cfg=cfg))
        self._loss_fn = api.loss_fn(cfg)
        self.gather = None

    def _grad(self, params, batch):
        named = dict(params.named_parameters())
        fwd = params if self.gather is None else self.gather(params)
        loss, metrics = self._loss_fn(fwd, batch, knobs=self.knobs,
                                      ep_axis=self.ep_axis, mesh=self.mesh,
                                      remat=self.remat)
        grads = torch.autograd.grad(loss, list(named.values()),
                                    allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(named.items(), grads)}
        return loss.detach(), metrics, grads

    def body(self, params, opt, batch, sched=None) -> Dict[str, object]:
        """Forward, backward, the gradient-sync region (over a mesh),
        clipping and the AdamW update of ``params``
        and ``opt``'s moments in place, the schedule read from ``sched``
        (``optim.schedule_on``; written here when None); returns the
        metrics. Given ``sched``, reads nothing from the host and waits for
        nothing."""
        params.requires_grad_(True)
        if self.n_micro == 1:
            loss, metrics, grads = self._grad(params, batch)
        else:
            gsum, loss = None, 0.0
            for mb in _micro_split(batch, self.n_micro):
                l, metrics, g = self._grad(params, mb)
                g = {k: v.float() for k, v in g.items()}
                gsum = g if gsum is None else {k: gsum[k] + g[k] for k in g}
                loss = loss + l
            grads = {k: v / self.n_micro for k, v in gsum.items()}
            loss = loss / self.n_micro
        _, _, opt_metrics = optim.adamw_update(
            grads, opt, params, self.opt_cfg, sched,
            grad_reduce=self.grad_reduce)
        metrics = {k: v.detach() if torch.is_tensor(v) else v
                   for k, v in metrics.items()}
        return dict(metrics, loss=loss, **opt_metrics)

    def __call__(self, params, opt, batch):
        metrics = self.body(params, opt, batch)
        return params, opt._replace(step=opt.step + 1), metrics


def make_train_step(cfg: ModelConfig, knobs: ApproxKnobs = PRECISE, *,
                    opt_cfg: optim.OptConfig = optim.OptConfig(),
                    n_micro: int = 1, remat: str = "full",
                    ep_axis: Optional[str] = None, mesh=None,
                    param_pspecs=None) -> TrainStep:
    """Returns step(params, opt, batch) -> (params, opt, metrics); the
    parameters and moments are updated in place. Over ``mesh`` the
    gradients pass ``grad_reduce_for(knobs, mesh, param_pspecs)``'s region
    and MoE layers run expert parallel over ``ep_axis``."""
    return TrainStep(cfg, knobs, opt_cfg, n_micro, remat, ep_axis, mesh,
                     param_pspecs)


def train_launches() -> Dict[str, int]:
    """The train path's kernel wrappers' launch counts (the capture of a
    graph counts as one call of each; its replays call none)."""
    return {"flash_attention": flash_attention.launches,
            "int8_matmul": int8_matmul.launches,
            "quantize_rows": quantize_rows.launches,
            "ssd_scan": ssd_scan.launches,
            "ssd_scan_backward": ssd_scan.backward_launches}


def state_tensors(params, opt):
    """The parameters and both AdamW moments, in one order."""
    return (list(params.parameters()) + list(opt.m.values())
            + list(opt.v.values()))


class GraphedTrainStep:
    """``step`` (a ``TrainStep``) as one CUDA graph on ``device``: the
    counterpart of ``jax.jit`` of the JAX package's train step, with the
    same call, ``(params, opt, batch) -> (params, opt, metrics)``.

    The first call allocates a static buffer for every leaf of the batch
    and the schedule scalars, runs a real step of the body on a side stream
    (the warm-up whole-network capture needs: it builds and loads the
    kernels, grants their shared memory and sets up cuBLAS; its metrics are
    that step's), then captures the body on those buffers into a graph
    whose memory comes from ``pool`` (shared by every variant of a table:
    one replays at a time). Each later call copies the batch into the
    buffers, writes the schedule scalars from pinned memory, replays, and
    copies the metrics out of the pool, so that another variant's replay
    cannot overwrite them; nothing waits for the device. The graph holds
    the addresses of the parameters and AdamW moments, which the update
    and ``load_state`` write in place: every call checks that they have not
    moved, and that the batch has the captured shapes, and raises if not.
    A capture that fails raises; nothing falls back to the eager step.

    On the CPU (no graphs) a call runs the same protocol uncaptured: the
    batch copied in, the scalars written, the body run on the buffers, the
    metrics copied out.

    ``stats``: ``capture_s`` (the capture alone; ``warmup_s`` the warm-up
    step), ``replays``, ``launches`` (each kernel's launches in the graph:
    the wrappers' calls during the capture, which launched nothing),
    ``pool_bytes`` (what the capture added to the reserved device
    memory), ``wire`` (the bytes a position of the step's mesh would send
    a step, by axis: what ``collectives.WIRE`` added during the capture;
    on the CPU, during the last call)."""

    def __init__(self, step: TrainStep, device, pool=None):
        self.step, self.device, self.pool = step, torch.device(device), pool
        self.graph = None
        self.stats = dict(capture_s=0.0, warmup_s=0.0, replays=0,
                          launches={}, pool_bytes=0, wire={})
        self._batch = self._sched = self._out = self._ptrs = None

    def __call__(self, params, opt, batch):
        if self._batch is None:
            self._batch = {k: torch.empty_like(v, device=self.device)
                           for k, v in batch.items()}
            self._sched = torch.empty(3, dtype=torch.float32,
                                      device=self.device)
            self._ptrs = [t.data_ptr() for t in state_tensors(params, opt)]
        self._check(params, opt, batch)
        for k, buf in self._batch.items():
            buf.copy_(batch[k], non_blocking=True)
        optim.schedule_on(self.step.opt_cfg, opt.step, self.device,
                          out=self._sched)
        if self.device.type != "cuda":
            mark = collectives.WIRE.mark()
            out = self._body(params, opt)
            self.stats["wire"] = collectives.WIRE.by_axis(mark)
        elif self.graph is None:
            out = self._warm_up_and_capture(params, opt)
        else:
            self.graph.replay()
            self.stats["replays"] += 1
            out = self._out
        metrics = {k: v.clone() if torch.is_tensor(v) else v
                   for k, v in out.items()}
        return params, opt._replace(step=opt.step + 1), metrics

    def _body(self, params, opt):
        return self.step.body(params, opt, self._batch, self._sched)

    def release(self) -> None:
        """Drop the graph and what it holds (its outputs in the pool, the
        batch buffers), so that the pool's memory can return to the card
        once no graph uses it; ``stats`` stay. A later call starts over
        with a warm-up step and a capture."""
        self.graph = self._out = self._batch = self._sched = None
        self._ptrs = None

    def _check(self, params, opt, batch):
        if [t.data_ptr() for t in state_tensors(params, opt)] != self._ptrs:
            raise RuntimeError(
                "GraphedTrainStep: the parameters or AdamW moments moved "
                "since the first call; the step updates them in place, and "
                "a restore must copy into them (ckpt.load_state)")

        def spec(b):
            return {k: (tuple(v.shape), v.dtype) for k, v in b.items()}
        if spec(batch) != spec(self._batch):
            raise ValueError(f"GraphedTrainStep: batch {spec(batch)} "
                             f"differs from the first call's "
                             f"{spec(self._batch)}")

    def _warm_up_and_capture(self, params, opt):
        dev = self.device
        t0 = time.perf_counter()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            warm = self._body(params, opt)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()     # as the capture's entry does
        t1 = time.perf_counter()
        before, reserved = train_launches(), torch.cuda.memory_reserved(dev)
        mark = collectives.WIRE.mark()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool):
            self._out = self._body(params, opt)
        after = train_launches()
        self.graph = graph
        self.stats.update(
            warmup_s=t1 - t0, capture_s=time.perf_counter() - t1,
            launches={k: after[k] - before[k] for k in after},
            pool_bytes=torch.cuda.memory_reserved(dev) - reserved,
            wire=collectives.WIRE.by_axis(mark))
        return warm


def graphed_train_step(step: TrainStep, device, pool=None):
    """``step`` as a ``GraphedTrainStep`` on a CUDA ``device`` (its memory
    from ``pool``, a ``torch.cuda.graph_pool_handle()``, when given), or
    ``step`` itself on the CPU."""
    if torch.device(device).type != "cuda":
        return step
    return GraphedTrainStep(step, device, pool)


def replayed_launches(steps: Iterable) -> Dict[str, int]:
    """Kernel launches of the replayed train graphs among ``steps``: each
    graph's launches counted at its capture times its replays (the
    wrappers' counters see only the capture)."""
    out = dict.fromkeys(train_launches(), 0)
    for s in steps:
        for name, n in getattr(s, "stats", {}).get("launches", {}).items():
            out[name] += n * s.stats["replays"]
    return out


def make_serve_step(cfg: ModelConfig, knobs: ApproxKnobs = PRECISE):
    """Returns step(params, tokens, position, caches[, enc_out]) ->
    (logits, caches): one new token against the KV/SSM caches (updated in
    place); the encoder-decoder's step also takes the encoder's output."""
    decode = api.decode_fn(cfg)

    if cfg.family == "encdec":
        def step(params, tokens, position, caches, enc_out):
            return decode(params, tokens, position, caches, enc_out,
                          knobs=knobs)
        return step

    def step(params, tokens, position, caches):
        return decode(params, tokens, position, caches, knobs=knobs)
    return step


def make_prefill_fn(cfg: ModelConfig, knobs: ApproxKnobs = PRECISE, *,
                    remat: str = "full"):
    """Returns prefill(params, batch) -> the last-token logits (B, V) fp32
    of a full forward over ``batch["tokens"][:, :-1]`` (the prefill cell):
    after the encoder over ``frames`` for the encoder-decoder, after the
    ``prefix_embeds`` for the vlm."""

    def prefill(params, batch):
        if cfg.family == "encdec":
            enc_out = encdec_mod.encode(params, batch["frames"], cfg, knobs,
                                        remat=remat)
            h = encdec_mod.decode_hidden(params, batch["tokens"][:, :-1],
                                         enc_out, cfg, knobs, remat=remat)
        else:
            h, _ = lm_mod.forward_hidden(
                params, batch["tokens"][:, :-1], cfg, knobs, remat=remat,
                prefix_embeds=batch.get("prefix_embeds"))
        return lm_mod.logits_fn(params, h[:, -1], cfg)

    return prefill


def make_paged_megastep(cfg: ModelConfig, knobs: ApproxKnobs = PRECISE, *,
                        k: int, temperature: float = 0.0, seed: int = 0,
                        eos_id: int = -1, shards=1):
    """Returns step(params, cur, pos, alive, uids, draws, budget, caches)
    -> (toks (B, K), cur, pos, alive, draws, budget, caches): K decode steps
    with on-device sampling and stop masking (``lm.decode_megastep``). The
    carry and the caches are updated in place, so the engine chains
    megasteps on the device without a host sync between them, and a graph
    captured over ``k=1`` replays on the same tensors."""

    def step(params, cur, pos, alive, uids, draws, budget, caches):
        return lm_mod.decode_megastep(
            params, cur, pos, alive, uids, draws, budget, caches, cfg, knobs,
            k=k, temperature=temperature, seed=seed, eos_id=eos_id,
            shards=shards)
    return step
