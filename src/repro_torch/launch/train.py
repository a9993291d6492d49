"""Training driver with the Pliant runtime: the JAX package's
``launch/train.py`` in PyTorch.

Data pipeline -> one train-step closure per approximate variant -> Pliant
monitor/controller switching variants at step boundaries. With
``--pliant`` a synthetic contention trace on the colocated ``token-serve``
service drives the runtime: a burst in the middle 40% of the run pushes
the job to its most approximate variant, and the slack after it walks the
job back toward precise.

  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-780m \
      --steps 20 --batch 4 --seq 1024 --pliant --decision-interval 0

The default arch is phi4-mini-3.8b-smoke, as in the JAX driver; every arch
trains: whisper's batch carries ``frames`` (B, encoder_seq, d_model) and
paligemma's ``prefix_embeds`` (B, n_prefix_tokens, d_model), drawn each
step from a ``torch.Generator`` seeded from (seed, step) on the CPU, so a
run on the card sees the same batches as one on the CPU. ``--device cpu``
runs the kernels' plain versions on the CPU.

``--ckpt-dir DIR`` saves ``(params, opt)`` every ``--ckpt-period`` steps
(asynchronously, in the JAX package's checkpoint format) and once more at
the end; ``--resume`` restores the newest loadable checkpoint in DIR first
(a torn one is skipped with a warning), and the run continues from its
step with the data the uninterrupted run would have read there. A
checkpoint the JAX driver wrote restores as well; a restore copies into
the parameters and moments in place, where the captured steps read them.
``main(argv, remat=...)`` hands ``remat`` to ``build_variant_steps``:
"none" by default, as in the JAX driver; full-width phi4-mini-3.8b at 2 x
4096 tokens needs "full" to fit one 80 GB card.

``--pod-mesh`` lays ``--positions N`` positions of the device (8 by
default) out as a (2, N // 2) mesh over ("pod", "data"), so the
``sync_period`` and ``grad_compress`` knobs reach the owned gradient-sync
region (``train.step.grad_reduce_for``): every position is the one
device, the forward and backward run unsplit and the region records the
bytes each of its collectives would carry (``dist.collectives``). A variant with ``sync_period`` k > 1
carries no pod collective; the driver syncs the parameters over the pods
after every k-th step (``train.step.pod_sync``). ``--chaos SCRIPT``
scripts capacity events (``dist.elastic.FaultInjector``, e.g.
"revoke@3:2,restore@6"): a revocation shrinks the mesh to the survivors
(``surviving_mesh``), the parameters and AdamW state are staged through
the host onto it (``reshard_live``) and every variant's step is built anew
on the new mesh (fresh graphs on the card); a restore grows it back. The
events reach the job through the runtime's ``TrainTenant.elastic_fn``, as
in the JAX driver, which prints the same ``chaos:`` lines.

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --pod-mesh --positions 8 --chaos "revoke@3:2,restore@6" --steps 8

On the card each variant's step runs as one CUDA graph
(``build_variant_steps``): its first step is a real eager step that warms
the kernels, after which the step is captured and every later step of
that variant replays it; on the CPU the steps run eagerly. ``main``
prints the same ``step ... loss ... variant=...`` and ``final loss`` lines
as the JAX driver (and a ``train graphs:`` line on the card) and returns a
dict with the table and its steps, the trained state, the per-step
record (loss, wall seconds, seconds waiting for data, active variant),
the final mesh, each re-home (mesh shape, seconds) and every step built
(``all_steps``: those of every mesh the run was on).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import (CheckpointManager, load_state,
                                         state_like, state_tree)
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.colocation import SERVICES
from repro_torch.core.explorer import explore
from repro_torch.core.monitor import LatencyMonitor
from repro_torch.core.runtime import PliantRuntime
from repro_torch.core.tenant import TrainTenant
from repro_torch.core.variants import VariantTable
from repro_torch.data.pipeline import DataConfig, Prefetcher, SyntheticLM
from repro_torch.dist import elastic
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import api
from repro_torch.models.common import resolve_device
from repro_torch.train import optim
from repro_torch.train import step as step_mod


def build_variant_steps(cfg, table: VariantTable, opt_cfg, *, device,
                        remat="none", mesh=None):
    """One train step per variant of ``table`` (over ``mesh``, with the
    variant's gradient-sync region, when given), the counterpart of the
    JAX driver's ``jax.jit`` of each: on a CUDA ``device`` a
    ``GraphedTrainStep`` (captured at its first call, which is a real step;
    every variant's graph draws on one memory pool), on the CPU the eager
    ``TrainStep``. Installs them in ``table`` and returns them in its
    order; each graph's capture seconds, launches and wire bytes are in
    its ``stats``. Called again after a re-home, it builds fresh steps."""
    pool = (torch.cuda.graph_pool_handle()
            if torch.device(device).type == "cuda" else None)
    table.compile_all(lambda knobs: step_mod.graphed_train_step(
        step_mod.make_train_step(cfg, knobs, opt_cfg=opt_cfg, remat=remat,
                                 mesh=mesh),
        device, pool))
    return [table.executable(i) for i in range(len(table))]


def extra_inputs(cfg, batch: int, seed: int, step: int, device):
    """The stub frontends' inputs of one step: whisper's ``frames`` or
    paligemma's ``prefix_embeds``, standard normal fp32 from a CPU
    ``torch.Generator`` seeded from (seed, step); {} for the token-only
    families."""
    if cfg.family == "encdec":
        name, rows = "frames", cfg.encoder_seq
    elif cfg.family == "vlm":
        name, rows = "prefix_embeds", cfg.n_prefix_tokens
    else:
        return {}
    gen = torch.Generator().manual_seed(seed * 2 ** 32 + step)
    return {name: torch.randn((batch, rows, cfg.d_model),
                              generator=gen).to(device)}


def _reshard(params, opt, device):
    """``dist.elastic.reshard_live`` of (params, AdamW state): each tensor
    staged through the host and put back on ``device``; the parameters
    take the new tensors in place of theirs (the captured steps of the old
    mesh are dropped, and the new mesh's capture their addresses)."""
    named = dict(params.named_parameters())
    new_named, new_opt = elastic.reshard_live((named, opt), device)
    for k, p in named.items():
        p.data = new_named[k]
    return params, optim.OptState(
        new_opt.step, {k: new_opt.m[k] for k in opt.m},
        {k: new_opt.v[k] for k in opt.v})


def main(argv=None, remat="none"):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="phi4-mini-3.8b-smoke")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--pliant", action="store_true",
                   help="enable the Pliant runtime with a synthetic "
                        "contention trace on the token-serve service")
    p.add_argument("--ckpt-dir", default="")
    p.add_argument("--ckpt-period", type=int, default=50)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--decision-interval", type=float, default=0.5)
    p.add_argument("--pod-mesh", action="store_true",
                   help="lay --positions positions of the device out as a "
                        "(pod, data) mesh so the sync_period/grad_compress "
                        "knobs reach the owned gradient-sync region")
    p.add_argument("--positions", type=int, default=8,
                   help="mesh positions for --pod-mesh (all on --device)")
    p.add_argument("--chaos", default="",
                   help="capacity-event script for the fault injector, e.g. "
                        "'revoke@40:2,restore@120': revocations shrink the "
                        "train mesh (params and optimizer state restaged, "
                        "every variant's step rebuilt), restores grow it "
                        "back")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    params = api.init(cfg, args.seed, torch.float32, device)
    opt = optim.init_opt(params)
    opt_cfg = optim.OptConfig(lr=args.lr, warmup=20, total_steps=args.steps)

    mesh = None
    if args.pod_mesh:
        if args.positions >= 2:
            mesh = make_mesh((2, args.positions // 2), ("pod", "data"),
                             device)
        else:
            print("WARNING: --pod-mesh ignored (fewer than 2 --positions) "
                  "— pod collectives will be no-ops")

    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    table = explore(cfg, shape, serving=False, max_variants=4)
    steps = build_variant_steps(cfg, table, opt_cfg, device=device,
                                remat=remat, mesh=mesh)
    names = [v.name for v in table.variants]

    monitor = LatencyMonitor(SERVICES["token-serve"].qos_target_s)
    tenant = TrainTenant(table, name="train")
    runtime = PliantRuntime(monitor=monitor, tenants=[tenant])
    runtime.cfg.decision_interval_s = args.decision_interval

    # --chaos: the TrainTenant's live shrink: (params, optimizer state)
    # staged through the host onto the surviving mesh, without the disk
    # round trip, and every variant's step rebuilt on it
    chaos = None
    live = {"params": None, "opt": None, "mesh": mesh, "lost": set(),
            "rehomes": [], "built": list(steps)}
    if args.chaos:
        chaos = elastic.FaultInjector.parse(args.chaos)
        base_mesh = mesh

        def on_capacity(ev):
            if ev.kind == elastic.REVOKE:
                if base_mesh is None:
                    print("chaos: revoke ignored (single device, no mesh)")
                    return
                ids = ev.devices or elastic.pick_revoked(
                    base_mesh, ev.count, already=tuple(live["lost"]))
                live["lost"].update(ids)
            elif ev.kind == elastic.RESTORE:
                if ev.devices:
                    live["lost"].difference_update(ev.devices)
                else:
                    live["lost"].clear()
            else:
                return      # quota/collective events: pressure-only here
            if live["lost"]:
                new_mesh, why = elastic.surviving_mesh(base_mesh,
                                                       live["lost"])
                if new_mesh is None:
                    print(f"chaos: cannot shrink ({why}) — degrading via "
                          "the variant ladder only")
                    return
            else:
                new_mesh, why = base_mesh, "full mesh restored"
            t = time.time()
            for s in steps:         # the old mesh's graphs and their pool
                getattr(s, "release", lambda: None)()
            if device.type == "cuda":
                torch.cuda.empty_cache()
            live["params"], live["opt"] = _reshard(live["params"],
                                                   live["opt"], device)
            steps[:] = build_variant_steps(cfg, table, opt_cfg,
                                           device=device, remat=remat,
                                           mesh=new_mesh)
            live["built"] += steps
            live["mesh"] = new_mesh
            dt = time.time() - t
            shape_s = "1x1" if new_mesh is None else \
                "x".join(str(v) for v in new_mesh.shape.values())
            live["rehomes"].append(dict(mesh=shape_s, seconds=dt,
                                        lost=sorted(live["lost"])))
            print(f"chaos: resharded (params+opt) onto {shape_s} in "
                  f"{dt:.2f}s ({why}; lost={sorted(live['lost'])})")

        tenant.elastic_fn = on_capacity
        print(f"chaos: {chaos.pending()} scripted capacity events "
              f"({args.chaos})")

    data_cfg = DataConfig(cfg.vocab_size, args.seq, args.batch,
                          seed=args.seed)
    source = SyntheticLM(data_cfg)
    start_step, mgr = 0, None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, period=args.ckpt_period,
                                to_host=lambda st: state_tree(st, cfg))
        if args.resume:
            restored, rstep = mgr.restore_latest(state_like((params, opt),
                                                            cfg))
            if restored is not None:
                params, opt = load_state(restored, (params, opt), cfg)
                del restored
                start_step = rstep
                print(f"resumed from step {rstep}")
    prefetch = Prefetcher(lambda s: source.batch(s), start_step)

    losses, step_s, wait_s, variants = [], [], [], []
    svc = SERVICES["token-serve"]
    t0 = time.time()
    try:
        for i in range(start_step, args.steps):
            if chaos is not None:
                due = chaos.due(i)
                if due:
                    live["params"], live["opt"] = params, opt
                    for ev in due:
                        print(f"chaos@{i}: {ev.kind} count={ev.count} "
                              f"quanta={ev.quanta}")
                        runtime.inject(ev)
                    params, opt = live["params"], live["opt"]
            t_step = time.perf_counter()
            _, tokens = next(prefetch)
            wait_s.append(time.perf_counter() - t_step)
            batch = {"tokens": torch.as_tensor(tokens, device=device),
                     **extra_inputs(cfg, args.batch, args.seed, i, device)}
            active = runtime.active_variant if args.pliant else 0
            step_fn = table.executable(active)
            params, opt, metrics = step_fn(params, opt, batch)
            knobs = table.variants[active].knobs
            if knobs.sync_period > 1 and (i + 1) % knobs.sync_period == 0:
                # the step carries no pod collective: sync the params over
                # the pods every k steps (a no-op without a pod axis)
                step_mod.pod_sync(params, live["mesh"])
            losses.append(float(metrics["loss"]))
            step_s.append(time.perf_counter() - t_step)
            variants.append(active)
            if args.pliant:
                # synthetic contention trace: mid-run interference burst on
                # the colocated interactive service
                phase = (i - start_step) / max(args.steps - start_step, 1)
                burst = 1.0 if 0.3 < phase < 0.7 else 0.0
                v = table.variants[runtime.active_variant]
                interf = burst * (svc.sens_mem * v.pressure.hbm
                                  + svc.sens_ici * v.pressure.ici)
                p99 = svc.p99(0.775, interf, runtime.reclaimed)
                rng = np.random.default_rng(i)
                for x in p99 / 3.2 * np.exp(0.45 * rng.standard_normal(64)):
                    monitor.record(float(x))
                runtime.maybe_decide()
            if mgr is not None:
                mgr.maybe_save((params, opt), i + 1)
            if (i + 1) % 20 == 0:
                v = names[runtime.active_variant] if args.pliant \
                    else "precise"
                print(f"step {i+1:5d} loss {np.mean(losses[-20:]):.4f} "
                      f"variant={v} reclaimed={runtime.reclaimed} "
                      f"({(time.time()-t0) / (i+1-start_step):.2f}s/step)")
    finally:
        prefetch.close()
    if mgr is not None:
        mgr.save_sync((params, opt), args.steps)
        mgr.wait()
        print("checkpoints: " + ", ".join(
            f"step {t['step']} " + (f"restored in {t['restore_s']:.1f}s"
                                    if "restore_s" in t else
                                    f"host copy {t['host_s']:.1f}s, write "
                                    f"{t['write_s']:.1f}s")
            for t in mgr.timings))
    graphs = [s.stats for s in steps if isinstance(
        s, step_mod.GraphedTrainStep) and s.graph is not None]
    if graphs:
        print(f"train graphs: captured={len(graphs)} capture_s="
              f"{sum(g['capture_s'] for g in graphs):.3f} replays="
              f"{sum(g['replays'] for g in graphs)}")
    final = float(np.mean(losses[-10:]))
    print(f"final loss {final:.4f} (first-10 {np.mean(losses[:10]):.4f})")
    if args.pliant:
        switches = [h for h in runtime.history if h["action"] != "hold"]
        print(f"pliant actions: {len(switches)} "
              f"{[h['action'] for h in switches[:8]]}")
    return dict(final_loss=final, losses=losses, step_s=step_s,
                wait_s=wait_s, variants=variants, names=names, table=table,
                params=params, opt=opt, runtime=runtime, source=source,
                cfg=cfg, start_step=start_step, steps=steps,
                ckpt_timings=mgr.timings if mgr is not None else [],
                mesh=live["mesh"], rehomes=live["rehomes"],
                all_steps=live["built"])


if __name__ == "__main__":
    main()
