"""Multi-pod dry-run: trace one position's program of every (arch x shape x
mesh x variant) cell on ``meta`` tensors (nothing is allocated, no card is
needed), count what the card would execute, and write the JAX package's
dry-run artifact (FLOPs, bytes accessed, argument / output / temp / alias
bytes, the peak, collectives by kind, the roofline terms) as JSON.

Counterpart of the JAX package's ``launch/dryrun.py``, which lowers and
compiles each cell for a forced 512-device host and reads XLA's
``cost_analysis`` / ``memory_analysis`` and the optimized HLO. Here:

* The position's program. ``Cell`` builds the parameters, AdamW moments,
  inputs and caches at one position's shapes from ``param_shardings`` /
  ``input_shardings`` / ``cache_shardings`` (the batch split over
  ("pod", "data"); a dim whose size does not divide its mesh axis stays
  whole). A leaf's memory follows its spec; its compute follows what the
  position computes: the model runs on a config cut to the position's
  share of the dims the ``model`` axis splits (attention heads when
  ``n_heads`` and ``n_kv_heads`` both divide, ``d_ff``, the vocabulary,
  Mamba's inner width and heads, the experts' weights under expert
  parallelism), and a leaf stored split on a dim the position computes
  whole (the FSDP ``embed`` dim, heads that do not divide) is all-gathered
  before use (``dist.implied.Gather``; every such leaf at the step's start,
  so the peak holds them all at once where XLA gathers a layer at a time).
  A decode cell's cache keeps every head and splits its length over
  ``model``, so its attention runs every head over the position's part of
  the cache.
* The count. ``repro_torch.cost.CountingMode`` counts every aten op's
  FLOPs (as XLA's ``HloCostAnalysis`` counts them) and bytes (eager
  PyTorch's traffic: nothing fuses), each hand-written kernel's own work
  (its ``work`` function; on ``meta`` every kernel wrapper takes the
  card's path up to the launch), the peak of live bytes, and every
  collective: the owned ones of ``dist.collectives`` (the gradient-sync
  region, the pod sync, MoE's expert exchange, each run as one position's
  block) and the ones GSPMD would insert (``dist.implied``, recorded where
  they would happen). ``roofline.collective_bytes`` prices them with the
  JAX package's ring coefficients.
* What has no counterpart: ``flags.py``, ``loop_trips`` and ``--probe3``
  exist because XLA's cost analysis counts a ``while`` body once; the
  port's layer loops are Python loops, so the trace visits every body.
  ``lower_s`` / ``compile_s`` become ``trace_s``, and ``probes`` is {}.

The positions are ``meta`` by nature, as the JAX package's are forced host
devices: the dry-run touches no CUDA and runs on the CPU.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mamba2-780m \\
      --shape train_4k --mesh pod [--variant int8] [--n-micro 4] \\
      [--remat full] [--policy fsdp_tp] [--out results/dryrun]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mamba2-780m \\
      --pod-sync [--compress]
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import pathlib
import time
import traceback
from typing import Dict, Optional

import torch

from repro_torch import cost, roofline
from repro_torch.approx.knobs import PRECISE, ApproxKnobs
from repro_torch.configs import SHAPES, get_config, shape_applicable
from repro_torch.configs.base import ModelConfig, ShapeConfig, SSMConfig
from repro_torch.convert import jax_path
from repro_torch.dist import collectives, implied, sharding
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import api
from repro_torch.models import lm as lm_mod
from repro_torch.models.common import ParamTree
from repro_torch.train import optim
from repro_torch.train import step as step_mod

VARIANTS = {
    "precise": PRECISE,
    "int8": ApproxKnobs(matmul_precision="int8"),
    "drop25": ApproxKnobs(token_drop=0.25),
    "skip25": ApproxKnobs(layer_skip=0.25),
    "kvstride2": ApproxKnobs(kv_keep_stride=2),
    "topk_half": None,     # resolved per-arch below
    "int8_kvq": ApproxKnobs(matmul_precision="int8", kv_quant=True),
    "gint8": ApproxKnobs(grad_compress="int8"),   # int8-wire pod grad reduce
}

META = torch.device("meta")
TOP_OPS = 12          # ops kept in the artifact, by bytes and by FLOPs


def resolve_variant(name: str, cfg) -> ApproxKnobs:
    if name == "topk_half":
        if cfg.moe is None:
            raise SystemExit(f"{cfg.name} has no MoE top-k knob")
        return ApproxKnobs(topk_override=max(1, cfg.moe.top_k // 2))
    return VARIANTS[name]


@dataclasses.dataclass(frozen=True)
class _LocalSSM(SSMConfig):
    """An SSM config whose inner width is one position's share
    (``models.mamba2._dims`` reads ``d_inner``)."""
    d_inner: int = 0


# the logical axes of each part the ``model`` axis may split
_PART_AXES = {"attn": ("q_heads", "kv_heads"), "mlp": ("mlp",),
              "vocab": ("vocab",), "ssm": ("ssm_inner", "ssm_heads"),
              "expert": ("expert",)}


class _Tree:
    """Attribute access to a nested dict / list of tensors, as
    ``ParamTree`` gives it: what the forward reads after the gathers."""

    def __init__(self, tree):
        for k, v in tree.items():
            setattr(self, k, _wrap(v))


def _wrap(v):
    if isinstance(v, dict):
        return _Tree(v)
    if isinstance(v, (list, tuple)):
        return [_wrap(x) for x in v]
    return v


class Cell:
    """One position's program of a cell: the splits of the ``model`` axis,
    the config cut to them, and each leaf's stored and computed shapes.

    ``parts``: the parts whose dims the position's compute splits over
    ``model`` (``"attn"``, ``"mlp"``, ``"vocab"``, ``"ssm"``, and
    ``"expert"`` under expert parallelism); ``local_cfg`` the config cut
    to them; ``pspecs`` the parameters' spec tree; ``store`` and
    ``compute`` {name: shape}: a leaf's block and the tensor the forward
    reads; ``gather`` {name: (mesh axes, positions)} of the leaves
    all-gathered before use."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, mesh,
                 knobs: ApproxKnobs, *, policy: Optional[str] = None,
                 n_micro: int = 1, remat: str = "full",
                 dtype=torch.bfloat16, decode2d: bool = False):
        self.cfg, self.shape, self.mesh, self.knobs = cfg, shape, mesh, knobs
        self.policy = policy or sharding.default_policy(cfg)
        self.n_micro, self.remat, self.dtype = n_micro, remat, dtype
        self.decode2d = decode2d
        rules = sharding.POLICIES[self.policy]
        m = mesh.shape.get("model", 1)
        self.m = m
        on_model = {a for a, ax in rules.items() if ax == "model"}
        parts = set()
        if m > 1:
            if (shape.kind != "decode" and {"q_heads", "kv_heads"} <= on_model
                    and cfg.n_heads % m == 0 and cfg.n_kv_heads % m == 0):
                parts.add("attn")
            if cfg.moe is None and "mlp" in on_model and cfg.d_ff \
                    and cfg.d_ff % m == 0:
                parts.add("mlp")
            if "vocab" in on_model and cfg.vocab_size % m == 0:
                parts.add("vocab")
            if cfg.ssm is not None and "ssm_inner" in on_model:
                di = cfg.ssm.expand * cfg.d_model
                if di % m == 0 and (di // cfg.ssm.head_dim) % m == 0:
                    parts.add("ssm")
            if cfg.moe is not None and cfg.moe.n_experts % m == 0:
                parts.add("expert")
        self.parts = frozenset(parts)
        # expert parallelism over ``model`` (the JAX dry-run's ``ep_axis``)
        self.ep_axis = "model" if "expert" in parts else None
        self.local_cfg = self._cut(cfg)
        self.pspecs = sharding.param_shardings(cfg, mesh, self.policy)
        specs = sharding.named_specs(api.model_specs(cfg))
        pspecs = sharding.named_specs(self.pspecs)
        self.specs, self.store, self.compute, self.gather = specs, {}, {}, {}
        split_axes = {a for p in self.parts for a in _PART_AXES[p]}
        for name, s in specs.items():
            spec = pspecs[name]
            self.store[name] = sharding.local_shape(s.shape, spec, mesh)
            comp, axes = list(s.shape), []
            for d, (size, ax_name, part) in enumerate(zip(s.shape, s.axes,
                                                          spec)):
                if part is None:
                    continue
                if part == "model" and ax_name in split_axes:
                    comp[d] = size // m
                else:
                    axes.append(part)
            self.compute[name] = tuple(comp)
            if axes:
                self.gather[name] = (",".join(axes), math.prod(
                    mesh.shape[a] for a in axes))
        self.plan = implied.Plan(
            model=m, split=self.parts - {"expert"},
            seq=self._seq_shards() if shape.kind == "decode" else 1,
            ep=m if "expert" in self.parts else 1,
            axes=tuple(mesh.shape.items()))

    def _cut(self, cfg: ModelConfig) -> ModelConfig:
        m, kw = self.m, {}
        if "attn" in self.parts:
            kw.update(n_heads=cfg.n_heads // m,
                      n_kv_heads=cfg.n_kv_heads // m,
                      head_dim=cfg.resolved_head_dim)
        if "mlp" in self.parts:
            kw["d_ff"] = cfg.d_ff // m
        if "vocab" in self.parts:
            kw["vocab_size"] = cfg.vocab_size // m
        if "ssm" in self.parts:
            fields = dataclasses.asdict(cfg.ssm)
            kw["ssm"] = _LocalSSM(**fields, d_inner=cfg.ssm.expand
                                  * cfg.d_model // m)
        return dataclasses.replace(cfg, **kw) if kw else cfg

    def _seq_shards(self) -> int:
        m = self.m
        return m if m > 1 and self.shape.seq_len % m == 0 else 1

    # ---------------------------------------------------------- arguments

    def input_specs(self):
        """{name: spec} of the inputs (``sharding.input_shardings``; the
        batch whole under ``decode2d``)."""
        specs = sharding.input_shardings(self.cfg, self.shape, self.mesh)
        if self.decode2d:
            specs = {k: sharding.P(*([None] * len(v)))
                     for k, v in specs.items()}
        return specs

    def batch_rows(self) -> int:
        spec = self.input_specs()["tokens"]
        return sharding.local_shape((self.shape.global_batch,), spec[:1],
                                    self.mesh)[0]

    def params(self) -> ParamTree:
        """The parameters a position holds, as ``meta`` tensors under
        ``model_specs``' names (``ssm_a`` / ``ssm_dt`` leaves in fp32,
        as ``api.abstract``)."""
        def leaf(n):
            dt = (torch.float32 if self.specs[n].init in ("ssm_a", "ssm_dt")
                  else self.dtype)
            return torch.empty(self.store[n], dtype=dt, device=META)
        flat = {n: leaf(n) for n in self.specs}
        return ParamTree(collectives._rebuild(api.model_specs(self.cfg),
                                              flat))

    def forward_params(self, params: ParamTree):
        """What the forward reads: each gathered leaf all-gathered to its
        compute shape (``implied.Gather``), the others as held."""
        if not self.gather:
            return params
        named = dict(params.named_parameters())
        flat = {}
        for n, p in named.items():
            if n in self.gather:
                axes, k = self.gather[n]
                flat[n] = implied.Gather.apply(p, self.compute[n], axes, k)
            else:
                flat[n] = p
        return _Tree(collectives._rebuild(api.model_specs(self.cfg), flat))

    def inputs(self, device=META, seed: int = 0) -> Dict[str, torch.Tensor]:
        """The inputs a position holds, ``meta`` tensors (or, on another
        device, ``api.make_inputs``' draws from ``seed``)."""
        pspecs = self.input_specs()
        local = {k: (sharding.local_shape(shp, pspecs[k], self.mesh), dt)
                 for k, (shp, dt) in api.input_specs(self.cfg,
                                                     self.shape).items()}
        if torch.device(device).type == "meta":
            return {k: torch.empty(shp, dtype=dt, device=device)
                    for k, (shp, dt) in local.items()}
        gen = torch.Generator(device=device).manual_seed(seed)
        return api.make_inputs(self.cfg, local, gen, device)

    def caches(self):
        """(computed caches, their stored bytes): the decode caches at the
        position's compute shapes (heads and inner widths of ``local_cfg``,
        the length split over ``model``), and the bytes its blocks of
        ``cache_shardings``' caches hold."""
        spec, glob = sharding.cache_shardings(self.cfg, self.shape,
                                              self.mesh)
        if self.decode2d:
            spec = tuple(type(c)(*(sharding.P(None, None, *s[2:])
                                   if len(s) > 1 else s for s in c))
                         for c in spec)
        stored = sum(math.prod(sharding.local_shape(x.shape, s, self.mesh))
                     * x.element_size() for c, cs in zip(glob, spec)
                     for x, s in zip(c, cs))
        seq = self.plan.seq
        comp = lm_mod.init_caches(self.local_cfg, self.batch_rows(),
                                  self.shape.seq_len // seq, device=META)
        return comp, stored


def compute_kind(knobs: ApproxKnobs, dtype) -> str:
    """The dtype whose peak prices a cell's compute term: "int8" on an
    int8 rung, else the parameters' ("fp32" or "bf16")."""
    if knobs.matmul_precision == "int8":
        return "int8"
    return "fp32" if dtype == torch.float32 else "bf16"


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def train_step(cell: Cell, opt_cfg: optim.OptConfig = optim.OptConfig()):
    """The position's ``TrainStep``: the cut config's step, its gathers,
    and the gradient-sync region run on the position's blocks."""
    step = step_mod.make_train_step(
        cell.local_cfg, cell.knobs, opt_cfg=opt_cfg, n_micro=cell.n_micro,
        remat=cell.remat, ep_axis=cell.ep_axis, mesh=cell.mesh,
        param_pspecs=cell.pspecs)
    step.grad_reduce = step_mod.grad_reduce_for(
        cell.knobs, cell.mesh, cell.pspecs,
        stacks=functools.partial(jax_path, cfg=cell.cfg), blocks=True)
    step.gather = cell.forward_params if cell.gather else None
    return step


def count_train(cell: Cell, step, params, opt, batch, sched
                ) -> cost.CountingMode:
    """One train step's body under a counting mode (and the cell's
    implied-collective plan); ``sched`` is made beforehand, as the
    captured step reads it from its buffer."""
    with implied.tracing(cell.plan), cost.CountingMode() as mode:
        mode.metrics = step.body(params, opt, batch, sched)
    return mode


def trace_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, knobs, *,
               policy=None, n_micro: int = 1, remat: str = "full",
               dtype=torch.bfloat16, decode2d: bool = False) -> dict:
    """One position's program of the cell traced on ``meta``: the
    counterpart of the JAX package's ``lower_cell`` +
    ``_compile_and_measure``. Returns the measurements (the artifact's
    keys before the roofline terms)."""
    cell = Cell(cfg, shape, mesh, knobs, policy=policy, n_micro=n_micro,
                remat=remat, dtype=dtype, decode2d=decode2d)
    t0 = time.time()
    params = cell.params()
    inputs = cell.inputs()
    mark = collectives.WIRE.mark()
    if shape.kind == "train":
        opt = optim.init_opt(params)
        step = train_step(cell)
        sched = optim.schedule_on(step.opt_cfg, 0, META)
        mode = count_train(cell, step, params, opt, inputs, sched)
        state = list(params.parameters()) + list(opt.m.values()) \
            + list(opt.v.values())
        alias = _nbytes(state) + 4          # + the int32 step counter
        args = alias + _nbytes(inputs.values())
        outs = alias + _nbytes(v for v in mode.metrics.values()
                               if torch.is_tensor(v))
    else:
        caches, cache_bytes = (cell.caches() if shape.kind == "decode"
                               else (None, 0))
        with torch.no_grad(), implied.tracing(cell.plan), \
                cost.CountingMode() as mode:
            fwd = cell.forward_params(params)
            if shape.kind == "prefill":
                out = step_mod.make_prefill_fn(cell.local_cfg, knobs,
                                               remat=remat)(fwd, inputs)
            else:
                extra = ((inputs["enc_out"],) if cfg.family == "encdec"
                         else ())
                out, _ = step_mod.make_serve_step(cell.local_cfg, knobs)(
                    fwd, inputs["tokens"], inputs["position"], caches,
                    *extra)
        alias = cache_bytes
        args = _nbytes(params.parameters()) + _nbytes(inputs.values()) \
            + cache_bytes
        outs = alias + _nbytes([out])
    trace_s = time.time() - t0
    wire = collectives.WIRE.since(mark)
    coll = roofline.collective_bytes(mode.collectives)
    return {
        "flops": mode.flops,
        "transcendentals": mode.transcendentals,
        "bytes_accessed": mode.bytes_accessed,
        "argument_bytes": int(args),
        "output_bytes": int(outs),
        "temp_bytes": int(mode.peak_bytes),
        "alias_bytes": int(alias),
        "collectives": coll,
        "collectives_by_source": {
            src: roofline.collective_bytes(
                [r for r in mode.collectives if r.source == src])
            for src in ("owned", "implied")},
        "wire": {f"{a}/{c}": b for (a, c), (_, b) in wire.items()},
        "kernels": mode.kernel_summary(),
        "kernel_records": [list(k) for k in mode.kernels],
        "ops": {k: list(v) for k, v in sorted(mode.by_op.items())},
        "top_ops_by_bytes": mode.top_ops("bytes", TOP_OPS),
        "top_ops_by_flops": mode.top_ops("flops", TOP_OPS),
        "uncounted_ops": dict(mode.uncounted),
        "parts_split": sorted(cell.parts),
        "gathered_leaves": len(cell.gather),
        "trace_s": round(trace_s, 3),
    }


def run_cell(arch: str, shape_name: str, mesh_kind: str, variant: str,
             *, policy=None, n_micro=1, remat="full",
             out_dir="results/dryrun", tag="", cfg=None, shape=None,
             mesh=None, dtype=torch.bfloat16, decode2d=False,
             write=True):
    """The JAX package's ``run_cell``: the same skips, the same artifact
    keys (``trace_s`` for ``lower_s`` / ``compile_s``, ``probes`` {}).
    ``cfg`` / ``shape`` / ``mesh`` override the named ones (a cut depth,
    another mesh)."""
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        print(f"SKIP {arch} x {shape_name}: {reason}")
        return {"skipped": reason, "arch": arch, "shape": shape_name}
    knobs = resolve_variant(variant, cfg)
    mesh = mesh or make_production_mesh(multi_pod=(mesh_kind == "multipod"))
    if knobs.grad_compress != "none" and "pod" not in mesh.shape:
        # without a pod axis the compressed reduce is a no-op and the cell
        # would silently measure identically to precise under a gint8 label
        reason = "grad_compress needs a pod axis (--mesh multipod)"
        print(f"SKIP {arch} x {shape_name} x {variant}: {reason}")
        return {"skipped": reason, "arch": arch, "shape": shape_name}
    n_chips = math.prod(mesh.shape.values())
    base = trace_cell(cfg, shape, mesh, knobs, policy=policy,
                      n_micro=n_micro, remat=remat, dtype=dtype,
                      decode2d=decode2d)
    art = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "mesh_shape": dict(mesh.shape), "variant": variant,
        "policy": policy or sharding.default_policy(cfg),
        "n_micro": n_micro, "remat": remat, "n_chips": n_chips,
        "dtype": str(dtype).split(".")[-1],
        **{k: base[k] for k in ("flops", "transcendentals",
                                "bytes_accessed", "argument_bytes",
                                "output_bytes", "temp_bytes",
                                "alias_bytes")},
        "peak_bytes_est": int(base["argument_bytes"] + base["temp_bytes"]
                              + base["output_bytes"]
                              - base["alias_bytes"]),
        "collectives": base["collectives"],
        "probes": {},
        "trace_s": base["trace_s"],
    }
    art.update({k: base[k] for k in ("collectives_by_source", "wire",
                                     "kernels", "kernel_records", "ops",
                                     "top_ops_by_bytes",
                                     "top_ops_by_flops", "uncounted_ops",
                                     "parts_split", "gathered_leaves")})
    mf = roofline.model_flops(cfg, shape, knobs)
    compute = compute_kind(knobs, dtype)
    terms = roofline.terms_from_artifact(art, mf, n_chips, compute)
    art.update({
        "model_flops_total": mf, "compute_dtype": compute,
        "compute_s": terms.compute_s, "memory_s": terms.memory_s,
        "collective_s": terms.collective_s, "dominant": terms.dominant,
        "useful_ratio": terms.useful_ratio,
        "roofline_fraction": terms.roofline_fraction,
    })
    name = f"{arch}__{shape_name}__{mesh_kind}__{variant}"
    if tag:
        name += f"__{tag}"
    if write:
        out = pathlib.Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        (out / f"{name}.json").write_text(json.dumps(art, indent=1))
    coll = art["collectives"]
    print(f"OK {name}: flops/chip={art['flops']:.3e} "
          f"bytes={art['bytes_accessed']:.3e} "
          f"wire={sum(coll.values()):.3e} "
          f"peak={art['peak_bytes_est'] / 2 ** 30:.2f}GiB "
          f"dominant={art['dominant']} "
          f"frac={art['roofline_fraction']:.3f} (trace {art['trace_s']}s)")
    return art


def run_pod_sync(arch: str, *, compress: bool, out_dir="results/dryrun",
                 cfg=None, mesh=None, policy=None, dtype=torch.bfloat16,
                 write=True):
    """The sync-elision knob's periodic cross-pod parameter sync as its
    own step: one position's blocks through ``pod_sync_params``, its
    wire bytes recorded. A train step under ``sync_period=k`` carries no
    pod collective; its amortised collective term is train_wire +
    sync_wire / k."""
    cfg = cfg or get_config(arch)
    mesh = mesh or make_production_mesh(multi_pod=True)
    cell = Cell(cfg, SHAPES["train_4k"], mesh, PRECISE, policy=policy,
                dtype=dtype)
    params = cell.params()
    mark = collectives.WIRE.mark()
    t0 = time.time()
    with torch.no_grad(), cost.CountingMode() as mode:
        collectives.pod_sync_params(dict(params.named_parameters()), mesh,
                                    compress=compress, pspecs=cell.pspecs,
                                    blocks=True)
    coll = roofline.collective_bytes(mode.collectives)
    wire = collectives.WIRE.since(mark)
    art = {"arch": arch, "kind": "pod_sync", "compress": compress,
           "collectives": coll, "wire_bytes": sum(coll.values()),
           "collective_s": sum(coll.values()) / roofline.LINK_BW,
           "wire": {f"{a}/{c}": b for (a, c), (_, b) in wire.items()},
           "flops": mode.flops, "bytes_accessed": mode.bytes_accessed,
           "trace_s": round(time.time() - t0, 3)}
    name = f"{arch}__podsync__multipod__{'int8' if compress else 'precise'}"
    if write:
        pathlib.Path(out_dir).mkdir(parents=True, exist_ok=True)
        (pathlib.Path(out_dir) / f"{name}.json").write_text(
            json.dumps(art, indent=1))
    print(f"OK {name}: wire={art['wire_bytes']:.3e} B "
          f"({art['collective_s']:.3f}s @NVLink)")
    return art


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch")
    p.add_argument("--shape")
    p.add_argument("--mesh", default="pod", choices=["pod", "multipod"])
    p.add_argument("--variant", default="precise")
    p.add_argument("--policy", default=None)
    p.add_argument("--n-micro", type=int, default=1)
    p.add_argument("--remat", default="full")
    p.add_argument("--out", default="results/dryrun")
    p.add_argument("--tag", default="")
    p.add_argument("--decode2d", action="store_true",
                   help="weight-stationary decode: batch unsharded, weights "
                        "2D-sharded, cache sequence over model")
    p.add_argument("--all", action="store_true")
    p.add_argument("--pod-sync", action="store_true",
                   help="measure the cross-pod param-sync step instead")
    p.add_argument("--compress", action="store_true")
    args = p.parse_args(argv)
    if args.pod_sync:
        return run_pod_sync(args.arch, compress=args.compress,
                            out_dir=args.out)
    kw = dict(policy=args.policy, n_micro=args.n_micro, remat=args.remat,
              out_dir=args.out, tag=args.tag, decode2d=args.decode2d)
    if args.all:
        from repro_torch.configs import ARCHS
        failures = []
        for arch in ARCHS:
            for shape_name in SHAPES:
                try:
                    run_cell(arch, shape_name, args.mesh, args.variant, **kw)
                except Exception as e:  # noqa: BLE001
                    traceback.print_exc()
                    failures.append((arch, shape_name, str(e)[:200]))
        if failures:
            print("FAILURES:", failures)
            raise SystemExit(1)
        return None
    return run_cell(args.arch, args.shape, args.mesh, args.variant, **kw)


if __name__ == "__main__":
    main()
