"""Training driver with the Pliant runtime: the JAX package's
``launch/train.py`` on one device, in PyTorch.

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

On the card each variant's step runs as one CUDA graph
(``build_variant_steps``): its first step is a real eager step that warms
the kernels, after which the step is captured and every later step of
that variant replays it; on the CPU the steps run eagerly. ``main``
prints the same ``step ... loss ... variant=...`` and ``final loss`` lines
as the JAX driver (and a ``train graphs:`` line on the card) and returns a
dict with the table and its steps, the trained state and the per-step
record (loss, wall seconds, seconds waiting for data, active variant).
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
from repro_torch.models import api
from repro_torch.models.common import resolve_device
from repro_torch.train import optim
from repro_torch.train import step as step_mod


def build_variant_steps(cfg, table: VariantTable, opt_cfg, *, device,
                        remat="none"):
    """One train step per variant of ``table``, the counterpart of the JAX
    driver's ``jax.jit`` of each: on a CUDA ``device`` a
    ``GraphedTrainStep`` (captured at its first call, which is a real step;
    every variant's graph draws on one memory pool), on the CPU the eager
    ``TrainStep``. Returns the steps in the table's order; each graph's
    capture seconds and launches are in its ``stats``."""
    pool = (torch.cuda.graph_pool_handle()
            if torch.device(device).type == "cuda" else None)
    table.compile_all(lambda knobs: step_mod.graphed_train_step(
        step_mod.make_train_step(cfg, knobs, opt_cfg=opt_cfg, remat=remat),
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
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    params = api.init(cfg, args.seed, torch.float32, device)
    opt = optim.init_opt(params)
    opt_cfg = optim.OptConfig(lr=args.lr, warmup=20, total_steps=args.steps)

    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    table = explore(cfg, shape, serving=False, max_variants=4)
    steps = build_variant_steps(cfg, table, opt_cfg, device=device,
                                remat=remat)
    names = [v.name for v in table.variants]

    monitor = LatencyMonitor(SERVICES["token-serve"].qos_target_s)
    tenant = TrainTenant(table, name="train")
    runtime = PliantRuntime(monitor=monitor, tenants=[tenant])
    runtime.cfg.decision_interval_s = args.decision_interval

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
            t_step = time.perf_counter()
            _, tokens = next(prefetch)
            wait_s.append(time.perf_counter() - t_step)
            batch = {"tokens": torch.as_tensor(tokens, device=device),
                     **extra_inputs(cfg, args.batch, args.seed, i, device)}
            active = runtime.active_variant if args.pliant else 0
            step_fn = table.executable(active)
            params, opt, metrics = step_fn(params, opt, batch)
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
                ckpt_timings=mgr.timings if mgr is not None else [])


if __name__ == "__main__":
    main()
