"""Open-loop serving driver: Poisson arrivals into the continuous-batching
engine, with the Pliant control loop (monitor -> controller -> variant
hot-swap) closed over per-token latency.

Serving variants come from the explorer's serving grid, ordered
precise-first. The engine is dense (per-slot rings, synchronous chunked
admission) unless ``--paged`` asks for the page pool, as in the JAX
package's driver, whose defaults these are:

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch phi4-mini-3.8b \
      --paged --dtype bf16 --requests 12 --slots 8 --max-len 1024 \
      --page-size 16 --prefill-chunk 128 --prompt-len 64 \
      --prompt-len-max 400 --max-new 16 --qos-target 0.001

``--megastep K`` (paged) decodes up to K tokens a dispatch (on the card, K
replays of one CUDA graph of the decode step; ``--sync-timing`` drains
each megastep before the next dispatch, so token stamps time the compute).
``--qos-target 0`` disables control (pin a variant with ``--variant``);
``--device cpu`` runs the kernels' plain versions on the CPU. ``--mesh DxM``
serves under a (data=D, model=M) mesh whose positions are all the one
device: admission chunks run ring attention over D sequence shards in turn
(the ``ring_hop`` kernel on the card), and the paged engine's decode makes
one ``paged_attention`` launch a slot-affinity shard when the slots split
over D. ``--chaos`` scripts capacity events (``dist.elastic``'s grammar,
polled each step), e.g. a revocation that re-homes the engine onto the
surviving mesh and a restore that grows it back:

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --arch phi4-mini-3.8b-smoke --paged --mesh 4x2 --slots 4 \
      --requests 8 --max-new 6 --max-len 32 --page-size 4 \
      --prefill-chunk 3 --prompt-len 7 --chaos "revoke@4+2:2,restore@9"

``main``
prints the summary lines and returns a dict with the engine, the requests
and the headline numbers; ``main(argv, cfg=)`` serves ``cfg`` (a config
cut in depth, say) in place of ``--arch``'s.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.controller import ControllerConfig
from repro_torch.core.explorer import decode_kv_share, explore
from repro_torch.core.monitor import LatencyMonitor
from repro_torch.core.runtime import PliantRuntime
from repro_torch.core.variants import VariantTable
from repro_torch.dist import elastic
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.lm import init_lm
from repro_torch.serve.engine import Request, ServeEngine

DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def serving_table(cfg: ModelConfig, *, slots: int, max_len: int,
                  max_loss: float = 0.05,
                  page_occupancy: float = None,
                  price_from_compile: bool = False) -> VariantTable:
    """The serving VariantTable for one engine shape, from the explorer.
    ``page_occupancy`` is the expected live-page fraction of the pool; it
    prices decode bytes by live pages. ``price_from_compile`` anchors that
    pricing on the traced decode step's bytes
    (``explorer.decode_kv_share``, the JAX package's compiled-cell
    pricing) instead of the coarse heuristic; the paged driver asks for
    it, as the JAX driver does."""
    shape = ShapeConfig("serve", max_len, slots, "decode")
    kv_share = None
    if price_from_compile and page_occupancy is not None:
        kv_share = decode_kv_share(cfg, slots, max_len)
    return explore(cfg, shape, serving=True, max_loss=max_loss,
                   page_occupancy=page_occupancy, kv_share=kv_share)


def percentiles(lat, ps=(50, 95, 99)):
    if not lat:
        return {p: float("nan") for p in ps}
    a = np.asarray(lat, float)
    return {p: float(np.percentile(a, p)) for p in ps}


def main(argv=None, *, cfg: ModelConfig = None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="gemma2-27b-smoke")
    p.add_argument("--requests", type=int, default=16)
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--max-new", type=int, default=12)
    p.add_argument("--max-len", type=int, default=64)
    p.add_argument("--prompt-len", type=int, default=6)
    p.add_argument("--prompt-len-max", type=int, default=0,
                   help="> --prompt-len: draw each prompt length uniformly "
                        "from [prompt-len, prompt-len-max]")
    p.add_argument("--prefill-chunk", type=int, default=16)
    p.add_argument("--rate", type=float, default=0.0,
                   help="Poisson arrival rate (req/s); 0 = all at t=0")
    p.add_argument("--qos-target", type=float, default=0.0,
                   help="per-token latency QoS target (s); 0 = no control")
    p.add_argument("--decision-interval", type=float, default=0.25)
    p.add_argument("--min-samples", type=int, default=0,
                   help="latency samples a decision needs (0 = scaled to "
                        "the engine width: min(20, max(4, 2 x slots)))")
    p.add_argument("--variant", default=None,
                   help="pin a variant by name (e.g. int8)")
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--mesh", default="",
                   help="serve under a mesh, e.g. 4x1 -> (data=4, model=1): "
                        "ring-attention admission over 4 sequence shards, "
                        "all on --device")
    p.add_argument("--paged", action="store_true",
                   help="paged page-pool caches with prefix reuse and the "
                        "pool_pages Pliant knob (default: dense rings)")
    p.add_argument("--page-size", type=int, default=8)
    p.add_argument("--pool-pages", type=int, default=0,
                   help="physical pages (0 = auto-size)")
    p.add_argument("--shared-prefix", type=int, default=0,
                   help="first N prompt tokens identical across requests")
    p.add_argument("--megastep", type=int, default=0,
                   help="fuse up to K decode steps per dispatch (on-device "
                        "sampling + EOS/budget stop masking, async double-"
                        "buffered host loop; K replays of a CUDA graph on "
                        "the card); paged only, 0 = one dispatch per token")
    p.add_argument("--eos-id", type=int, default=-1,
                   help="stop-token id; a request emitting it finishes "
                        "early (-1 = generate max-new tokens)")
    p.add_argument("--sync-timing", action="store_true",
                   help="drain every megastep before dispatching the next: "
                        "no pipeline overlap, but per-token stamps measure "
                        "compute instead of dispatch enqueue")
    p.add_argument("--max-admission-chunks", type=int, default=4)
    p.add_argument("--qos-guard", type=float, default=0.25)
    p.add_argument("--admission-timeout", type=float, default=0.0)
    p.add_argument("--chaos", default="",
                   help="capacity-event script for the fault injector, "
                        "e.g. 'revoke@20+4:2,restore@60' (dist.elastic "
                        "grammar: kind@step[+grace][:count])")
    p.add_argument("--device", default="cuda")
    p.add_argument("--dtype", default="fp32", choices=sorted(DTYPES),
                   help="params and KV cache dtype")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    cfg = cfg or get_config(args.arch)
    dtype = DTYPES[args.dtype]
    params = init_lm(cfg, args.seed, dtype, args.device)
    occupancy = (min(1.0, (args.prompt_len + args.max_new) / args.max_len)
                 if args.paged else None)
    table = serving_table(cfg, slots=args.slots, max_len=args.max_len,
                          page_occupancy=occupancy,
                          price_from_compile=args.paged)
    names = [v.name for v in table.variants]

    mesh = None
    if args.mesh:
        shape = args.mesh.split("x")
        if len(shape) != 2 or not all(x.isdigit() for x in shape):
            p.error(f"--mesh must be DxM (data x model), got {args.mesh!r}")
        mesh = make_mesh([int(x) for x in shape], ("data", "model"),
                         args.device)

    runtime = None
    if args.qos_target > 0:
        monitor = LatencyMonitor(
            qos_target_s=args.qos_target, window=1024,
            min_samples=(args.min_samples
                         or min(20, max(4, 2 * args.slots))))
        runtime = PliantRuntime(table, monitor, ControllerConfig(
            decision_interval_s=args.decision_interval))
    eng = ServeEngine(cfg, batch_slots=args.slots, max_len=args.max_len,
                      params=params, table=table, runtime=runtime,
                      temperature=args.temperature,
                      prefill_chunk=args.prefill_chunk, seed=args.seed,
                      cache_dtype=dtype, paged=args.paged,
                      page_size=args.page_size,
                      n_pages=args.pool_pages,
                      max_admission_chunks=args.max_admission_chunks,
                      qos_guard=args.qos_guard,
                      admission_timeout_s=args.admission_timeout,
                      eos_id=args.eos_id, megastep_k=args.megastep,
                      sync_timing=args.sync_timing, device=args.device,
                      mesh=mesh)
    print(f"dispatch: {eng.explain_dispatch()}")
    print(f"dispatch: {eng.explain_prefill_dispatch()}")
    print(f"dispatch: {eng.explain_megastep()}")
    injector = None
    if args.chaos:
        injector = elastic.FaultInjector.parse(args.chaos)
        print(f"chaos: {injector.pending()} scripted capacity events "
              f"({args.chaos})")
    if args.variant is not None:
        eng.set_variant(names.index(args.variant))

    rng = np.random.default_rng(args.seed)
    lengths = ([args.prompt_len] * args.requests
               if args.prompt_len_max <= args.prompt_len else
               list(rng.integers(args.prompt_len, args.prompt_len_max + 1,
                                 args.requests)))
    shared = list(rng.integers(1, cfg.vocab_size,
                               min(args.shared_prefix, args.prompt_len)))
    reqs = [Request(i, prompt=shared + list(rng.integers(
                        1, cfg.vocab_size, int(n) - len(shared))),
                    max_new=args.max_new) for i, n in enumerate(lengths)]
    arrivals = (np.cumsum(rng.exponential(1.0 / args.rate, args.requests))
                if args.rate > 0 else np.zeros(args.requests))

    t0 = time.perf_counter()
    nxt, steps = 0, 0
    while not all(r.done or r.rejected for r in reqs) and steps < 100_000:
        now = time.perf_counter() - t0
        while nxt < len(reqs) and arrivals[nxt] <= now:
            reqs[nxt].t_arrival = t0 + arrivals[nxt]
            eng.submit(reqs[nxt])
            nxt += 1
        if injector is not None:
            for ev in injector.due(steps):
                print(f"chaos@{steps}: {ev.kind} count={ev.count} "
                      f"quanta={ev.quanta} grace={ev.deadline_steps}")
                eng.inject(ev)
        if eng.idle:
            if nxt < len(reqs):      # open loop: idle until the next arrival
                time.sleep(min(arrivals[nxt] - now, 0.01))
                continue
            break
        eng.step()
        steps += 1
    wall = time.perf_counter() - t0

    # per-token latency seen by each request (inter-token gap; the first
    # token's gap runs from arrival: queueing + admission prefill)
    tok_lat, ttft, queue_wait, admit_compute = [], [], [], []
    for r in reqs:
        if not r.token_times:
            continue
        ts = [r.t_arrival or r.t_admit] + r.token_times
        tok_lat.extend(b - a for a, b in zip(ts, ts[1:]))
        ttft.append(r.token_times[0] - ts[0])
        if r.t_arrival and r.t_admit_start:
            queue_wait.append(r.t_admit_start - r.t_arrival)
        if r.t_admit:
            admit_compute.append(r.admit_compute_s)
    done = sum(r.done for r in reqs)
    toks = sum(len(r.out) for r in reqs)
    pct = percentiles(tok_lat)
    viol = (float(np.mean(np.asarray(tok_lat) > args.qos_target))
            if args.qos_target > 0 and tok_lat else 0.0)
    tok_s = toks / max(wall, 1e-9)
    print(f"variants: {names} (active={names[eng.active_variant]})")
    print(f"{done}/{len(reqs)} requests, {toks} tokens in {wall:.2f}s "
          f"({tok_s:.1f} tok/s, rate={args.rate}/s)")
    ttft95 = float(np.percentile(ttft, 95)) if ttft else float("nan")
    q95 = float(np.percentile(queue_wait, 95)) if queue_wait else 0.0
    a95 = float(np.percentile(admit_compute, 95)) if admit_compute else 0.0
    print(f"per-token latency ms: p50={1e3 * pct[50]:.1f} "
          f"p95={1e3 * pct[95]:.1f} p99={1e3 * pct[99]:.1f}  "
          f"ttft p95={1e3 * ttft95:.1f}  queue-wait p95={1e3 * q95:.1f}  "
          f"admit-compute p95={1e3 * a95:.1f}")
    if args.paged:
        s = eng.pool.stats
        looks = s["prefix_hits"] + s["prefix_misses"]
        chunks = [c for c, _ in eng.step_admission_chunks]
        print(f"paged: pages={eng.pool.spec.n_pages} "
              f"occupancy={eng.pool.occupancy():.2f} "
              f"peak_used={s['peak_used']} "
              f"prefix_hit_rate={s['prefix_hits'] / max(looks, 1):.2f} "
              f"tokens_skipped={s['tokens_skipped']} "
              f"reclaim_events={s['reclaim_events']}")
        print(f"admission: grouped_pages={s['grouped_pages']} "
              f"grouped_fallbacks={s['grouped_fallbacks']} "
              f"replenish_evictions={s['replenish_evictions']} "
              f"chunks/step max={max(chunks, default=0)} "
              f"budget_cap={args.max_admission_chunks}")
    if args.megastep:
        d_t = eng.row_dispatches / max(eng.row_tokens, 1)
        print(f"megastep: k={args.megastep} "
              f"decode_dispatches={eng.decode_dispatches} "
              f"dispatches/token={d_t:.2f} "
              f"drain_block_s={eng.drain_block_s:.3f}")
        if eng.graph_log:
            print(f"megastep graphs: captured={len(eng.graph_log)} "
                  f"capture_s={sum(g['capture_s'] for g in eng.graph_log):.3f}"
                  f" replays={sum(g['replays'] for g in eng.graph_log)}")
    if args.qos_target > 0:
        acts = [h["action"] for h in runtime.history if h["action"] != "hold"]
        print(f"qos: target={1e3 * args.qos_target:.1f}ms "
              f"violation_rate={viol:.3f} swaps={eng.swaps} actions={acts}")
    if args.chaos:
        s = eng.stats
        rehomes = [e for e in eng.elastic_log if "mesh_shape" in e]
        print(f"elastic: events={s['capacity_events']} "
              f"rehomes={s['rehomes']} "
              f"collective_retries={s['collective_retries']} "
              f"recovery_steps={[e['recovery_steps'] for e in rehomes]} "
              f"rejected={len(eng.rejected)} "
              f"timeouts={s['admission_timeouts']} "
              f"backoff_skips={s['backoff_skips']}")
        for e in rehomes:
            print(f"  rehome@{e['step']} {e['kind']}: mesh "
                  f"{e['mesh_shape']} shards {e['n_shards']} "
                  f"pages_migrated={e['pages_migrated']} "
                  f"cutover_s={e['cutover_s']:.4f} "
                  f"recovery_steps={e['recovery_steps']} ({e['why']})")
    if args.admission_timeout > 0:
        print(f"admission-timeout: rejected={len(eng.rejected)} "
              f"timeouts={eng.stats['admission_timeouts']} "
              f"backoff_skips={eng.stats['backoff_skips']}")
        for r in eng.rejected:
            rej = r.rejection
            print(f"  rejected uid={rej.uid} waited={rej.waited_s:.3f}s "
                  f"queue_depth={rej.queue_depth} step={rej.step}")
    return dict(engine=eng, requests=reqs, names=names, wall_s=wall,
                tok_s=tok_s, p50_s=pct[50], p99_s=pct[99], tokens=toks)


if __name__ == "__main__":
    main()
