"""Colocation harness: a REAL paged serving engine and a REAL train-step
job co-run on one device under ONE multi-tenant arbiter. The JAX package's
``launch/colocate.py`` in PyTorch, with the same arguments, defaults, loop,
summary keys and printed lines.

The interactive tenant is a paged ``ServeEngine`` whose per-token latencies
feed the ``LatencyMonitor``; the batch tenant runs its variant's train step
between engine steps. Both are ``Tenant`` adapters under one
``InterferenceAwareArbiter`` (or the round-robin baseline with
``--arbiter round_robin``):

* serve tenant — variant hot-swap (``request_variant``, deferred mid-
  admission) + ``pool_pages`` quanta (prefix cache evicted first);
* train tenant — variant hot-swap (one step closure a variant) + a
  DUTY-CYCLE quanta actuator: reclaiming k of its ``--train-groups``
  quanta skips k of every ``--train-groups`` loop turns, yielding the
  device's step-loop share to the serving engine.

The loop is serial on one stream: an engine step, then (on the turns the
duty cycle keeps) one train step whose loss is read back, which waits for
the device. A token's gap (what the summary's p99 measures) therefore
includes the train step that ran before it. The monitor the arbiter reads
is fed by the engine, as in the JAX harness: each decode step's own time
and each admission's time to first token, so a train step reaches it
through the admissions that span loop turns.

  PYTHONPATH=src python -m repro_torch.launch.colocate --device cpu \\
      --serve-arch phi4-mini-3.8b-smoke --train-arch mamba2-780m-smoke \\
      --requests 6 --slots 2 --max-new 4 --max-len 32 --qos-target 0.05

Beside the JAX harness's arguments: ``--device`` (CUDA unless ``cpu`` is
asked for; the kernels' plain versions run on the CPU) and ``--dtype`` for
the serve tenant's params and page pool (fp32 by default, as the JAX
harness inits; the train tenant stays fp32). ``main(argv, serve_params=,
train_params=)`` takes ready weights (``models.lm.ParamTree``) in place of
the seeded ones (``--seed`` and ``--seed + 1``); the train tenant's are
updated in place. ``main`` returns the summary with a ``run`` entry of
live objects (engine, requests, token latencies, each train step's loss
and variant, runtime, train tenant and table); ``--json`` writes the
summary without it.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.arbiter import InterferenceAwareArbiter, RoundRobinArbiter
from repro_torch.core.colocation import SERVICES
from repro_torch.core.controller import ControllerConfig
from repro_torch.core.explorer import explore
from repro_torch.core.monitor import LatencyMonitor
from repro_torch.core.runtime import PliantRuntime
from repro_torch.core.tenant import ServeTenant, TrainTenant
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch.serve import DTYPES, serving_table
from repro_torch.launch.train import build_variant_steps
from repro_torch.models.common import resolve_device
from repro_torch.models.lm import init_lm
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.train import optim


def token_latencies(reqs):
    """Every gap between a request's tokens; the first runs from arrival
    (queueing + admission), as the JAX harness measures it."""
    tok_lat = []
    for r in reqs:
        ts = [r.t_arrival or r.t_admit] + r.token_times
        tok_lat.extend(b - a for a, b in zip(ts, ts[1:]))
    return tok_lat


def main(argv=None, *, serve_params=None, train_params=None):
    p = argparse.ArgumentParser()
    p.add_argument("--serve-arch", default="gemma2-27b-smoke")
    p.add_argument("--train-arch", default="phi4-mini-3.8b-smoke")
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--slots", type=int, default=2)
    p.add_argument("--max-new", type=int, default=6)
    p.add_argument("--max-len", type=int, default=48)
    p.add_argument("--prompt-len", type=int, default=6)
    p.add_argument("--page-size", type=int, default=4)
    p.add_argument("--rate", type=float, default=100.0,
                   help="Poisson arrival rate (req/s); 0 = all at t=0")
    p.add_argument("--qos-target", type=float, default=0.05,
                   help="per-token latency QoS target (s)")
    p.add_argument("--decision-interval", type=float, default=0.05)
    p.add_argument("--train-batch", type=int, default=4)
    p.add_argument("--train-seq", type=int, default=64)
    p.add_argument("--train-groups", type=int, default=8,
                   help="duty-cycle quanta of the train tenant (reclaiming "
                        "k skips k of every train-groups loop turns)")
    p.add_argument("--arbiter", default="interference",
                   choices=["interference", "round_robin"])
    p.add_argument("--service", default="token-serve", choices=list(SERVICES),
                   help="sensitivity vector for contention attribution")
    p.add_argument("--json", default="", help="write summary JSON here")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--dtype", default="fp32", choices=sorted(DTYPES),
                   help="serve tenant's params and page-pool dtype")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    dtype = DTYPES[args.dtype]

    # ----------------------------------------------------- serve tenant ----
    scfg = get_config(args.serve_arch)
    sparams = (serve_params if serve_params is not None
               else init_lm(scfg, args.seed, dtype, device))
    stable = serving_table(
        scfg, slots=args.slots, max_len=args.max_len,
        page_occupancy=min(1.0, (args.prompt_len + args.max_new)
                           / args.max_len))
    eng = ServeEngine(scfg, batch_slots=args.slots, max_len=args.max_len,
                      params=sparams, table=stable,
                      page_size=args.page_size, seed=args.seed,
                      cache_dtype=dtype, device=device)
    serve_tenant = ServeTenant(engine=eng, name="serve")

    # ----------------------------------------------------- train tenant ----
    tcfg = get_config(args.train_arch)
    assert tcfg.family not in ("encdec", "vlm"), \
        "colocate's synthetic batch covers token-only families"
    tparams = (train_params if train_params is not None
               else init_lm(tcfg, args.seed + 1, torch.float32, device))
    topt = optim.init_opt(tparams)
    opt_cfg = optim.OptConfig(lr=1e-3, warmup=5, total_steps=1000)
    shape = ShapeConfig("cli", args.train_seq, args.train_batch, "train")
    ttable = explore(tcfg, shape, serving=False, max_variants=3)
    build_variant_steps(tcfg, ttable, opt_cfg)
    yielded = {"k": 0}      # duty-cycle actuator state (absolute quanta out)
    train_tenant = TrainTenant(
        ttable, name="train", reshard_fn=lambda k: yielded.update(k=k),
        max_reclaim=args.train_groups - 1, n_quanta=args.train_groups)

    # ------------------------------------------- one arbiter, two tenants --
    tenants = [serve_tenant, train_tenant]
    cfg = ControllerConfig(decision_interval_s=args.decision_interval)
    svc = SERVICES[args.service]
    if args.arbiter == "interference":
        arb = InterferenceAwareArbiter.from_tenants(
            tenants, cfg, sensitivity=svc.sensitivity)
    else:
        arb = RoundRobinArbiter.from_tenants(tenants, cfg)
    # tail-estimate floor scaled to engine width: one decode step contributes
    # at most ``slots`` samples and every decision consumes the window, so a
    # higher floor would starve the controller of any signal
    monitor = LatencyMonitor(qos_target_s=args.qos_target, window=1024,
                             min_samples=max(2, args.slots))
    runtime = PliantRuntime(monitor=monitor, cfg=cfg, tenants=tenants,
                            arbiter=arb)
    # the engine drives the shared control loop at its step boundaries
    # (latency feed + decision ticks); actuation arrives back through the
    # tenant adapters — including for the train job
    eng.attach_runtime(runtime, serve_tenant)

    # ------------------------------------------------------- open loop -----
    rng = np.random.default_rng(args.seed)
    reqs = [Request(i, prompt=list(rng.integers(1, scfg.vocab_size,
                                                args.prompt_len)),
                    max_new=args.max_new) for i in range(args.requests)]
    arrivals = (np.cumsum(rng.exponential(1.0 / args.rate, args.requests))
                if args.rate > 0 else np.zeros(args.requests))
    data = SyntheticLM(DataConfig(tcfg.vocab_size, args.train_seq,
                                  args.train_batch, seed=args.seed))

    t0 = time.perf_counter()
    nxt = it = train_steps = train_skipped = 0
    train_qloss = 0.0
    losses, train_variants = [], []
    while not all(r.done for r in reqs):
        now = time.perf_counter() - t0
        while nxt < len(reqs) and arrivals[nxt] <= now:
            reqs[nxt].t_arrival = t0 + arrivals[nxt]
            eng.submit(reqs[nxt])
            nxt += 1
        if not eng.idle:
            eng.step()
        # train tenant's duty cycle: run the step unless this turn is one of
        # the `yielded` skipped turns per `train-groups` window
        if it % args.train_groups >= yielded["k"]:
            step_fn = ttable.executable(train_tenant.variant)
            batch = {"tokens": torch.as_tensor(data.batch(train_steps),
                                               device=device)}
            tparams, topt, metrics = step_fn(tparams, topt, batch)
            losses.append(float(metrics["loss"]))
            train_variants.append(train_tenant.variant)
            train_qloss += ttable.variants[train_tenant.variant].quality_loss
            train_steps += 1
        else:
            train_skipped += 1
        it += 1
        if eng.idle and nxt < len(reqs):
            time.sleep(max(0.0, min(arrivals[nxt]
                                    - (time.perf_counter() - t0), 0.005)))
    wall = time.perf_counter() - t0

    # --------------------------------------------------------- summary -----
    tok_lat = token_latencies(reqs)
    toks = sum(len(r.out) for r in reqs)
    acts = [h for h in runtime.history if h["action"] != "hold"]
    victims = {t.name: sum(1 for h in acts if h["victim"] == i)
               for i, t in enumerate(tenants)}
    summary = {
        "arbiter": args.arbiter,
        "requests_done": int(sum(r.done for r in reqs)),
        "tokens": int(toks),
        "wall_s": wall,
        "tok_per_s": toks / max(wall, 1e-9),
        "p99_token_ms": (1e3 * float(np.percentile(tok_lat, 99))
                         if tok_lat else float("nan")),
        "violation_rate": (float(np.mean(np.asarray(tok_lat)
                                         > args.qos_target))
                           if tok_lat else 0.0),
        "train_steps": train_steps,
        "train_skipped": train_skipped,
        "train_mean_quality_loss": train_qloss / max(train_steps, 1),
        "train_final_loss": float(np.mean(losses[-5:])) if losses else None,
        "serve_variant": eng.active_variant,
        "train_variant": train_tenant.variant,
        "serve_reclaimed_pages": eng.pool.reclaimed,
        "train_yielded_quanta": yielded["k"],
        "actions": len(acts),
        "victims": victims,
        "swaps": eng.swaps,
    }
    print(f"[{args.arbiter}] {summary['requests_done']}/{len(reqs)} requests,"
          f" {toks} tokens in {wall:.2f}s ({summary['tok_per_s']:.1f} tok/s)")
    print(f"p99 token {summary['p99_token_ms']:.1f}ms "
          f"(target {1e3 * args.qos_target:.1f}ms, "
          f"violation_rate={summary['violation_rate']:.3f})")
    print(f"train: {train_steps} steps ({train_skipped} yielded turns), "
          f"variant={train_tenant.variant}, "
          f"mean_qloss={summary['train_mean_quality_loss']:.4f}")
    print(f"arbiter: {len(acts)} actions, victims={victims}, "
          f"serve_variant={eng.active_variant} "
          f"pool_reclaimed={eng.pool.reclaimed} "
          f"train_yielded={yielded['k']}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(summary, f, indent=1)
    return dict(summary, run=dict(
        engine=eng, requests=reqs, token_latencies=tok_lat, losses=losses,
        train_variants=train_variants, runtime=runtime,
        train_tenant=train_tenant, train_table=ttable))


if __name__ == "__main__":
    main()
