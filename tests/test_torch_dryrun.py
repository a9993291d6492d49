"""Twin of ``tests/test_dryrun_accounting.py`` for the port's dry-run
(``repro_torch.launch.dryrun``: one position's program traced on ``meta``
tensors under ``repro_torch.cost``'s counting mode), held to the JAX
package's compiled cells on the CPU: the calibration cell in one
8-device JAX subprocess, the decode pricing in a 1-device one, and two
production cells on JAX's own 512 forced host devices (argument bytes
exact there too).

Tolerances, and why they are not tighter (ROADMAP queue 3):

* argument bytes: exact;
* products (2·M·N·K: the port's ``mm`` / ``bmm`` and its kernels' work,
  JAX's ``dot`` instructions in the unrolled cell's optimized HLO):
  within 10%: the SSD's products are the kernel's causal triangles in the
  port and the reference's full Q x Q blocks in JAX;
* all FLOPs: the port's count 0.55–1.10 of JAX's unrolled compile: XLA's
  CPU cost analysis also counts the elementwise ops of its fused backward
  (the reference SSD's rank-5 decay masks, every conversion to fp32),
  which eager PyTorch runs as fewer, coarser ops;
* collective bytes: the totals 0.5–1.5 of JAX's: GSPMD all-reduces every
  gradient over ``data`` once a micro-batch as well as in the owned
  region, and reduces the SSD's per-chunk partials in fp32, where the
  port reduces once, in the region, and the scan's B and C gradients
  once a token;
* ``decode_kv_share``: the ring numerator exact, the share within 30% of
  JAX's (XLA counts the layer-group scan's body once, and its fusions
  keep intermediates out of memory; the trace counts every layer's eager
  traffic), the paged driver's ``rel_time``s within 3%.
"""
import ast
import dataclasses
import json
import pathlib

import pytest
import torch

from repro_torch import cost, roofline
from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh

REPO = pathlib.Path(__file__).resolve().parent.parent

SYNTH_HLO = """
  %all-gather.1 = bf16[2048,1024]{1,0} all-gather(bf16[128,1024]{1,0} %p0)
  %all-reduce.7 = f32[4096]{0} all-reduce(f32[4096]{0} %p1), replica_groups={}
  %reduce-scatter.2 = f32[256]{0} reduce-scatter(f32[4096]{0} %p2)
  %all-to-all.9 = s8[64,128]{1,0} all-to-all(s8[64,128]{1,0} %p3)
  %collective-permute.3 = bf16[32,32]{1,0} collective-permute(bf16[32,32]{1,0} %p4)
  %add.1 = f32[10]{0} add(f32[10]{0} %a, f32[10]{0} %b)
"""

JAX_SIDE = r'''
import dataclasses, json, re
import jax, jax.numpy as jnp
from repro import flags, roofline
from repro.configs import get_config, SHAPES, shape_applicable
from repro.configs.base import ShapeConfig
from repro.launch.mesh import make_mesh
from repro.launch import dryrun
from repro.dist import annotate
out = {"parser": roofline.collective_bytes(SYNTH)}

# the calibration cell: mamba2-780m-smoke, train 8 x 64, mesh (2, 4)
cfg = get_config("mamba2-780m-smoke")
shape = ShapeConfig("t", 64, 8, "train")
mesh = make_mesh((2, 4), ("data", "model"))
annotate.set_batch_axes(("data",))
knobs = dryrun.resolve_variant("precise", cfg)
def measure():
    return dryrun._compile_and_measure(cfg, shape, mesh, knobs, policy="tp",
                                       n_micro=2, remat="full")
flags.reset_unroll()
base = measure()
flops = base["flops"]
for site, extra in dryrun.loop_trips(cfg, shape, knobs, 2, "full").items():
    flags.reset_unroll(); flags.set_unroll(site, 2)
    flops += extra * max(measure()["flops"] - base["flops"], 0.0)
flags.reset_unroll()
from repro.models.lm import ce_chunk
flags.set_unroll("groups", cfg.n_groups)
flags.set_unroll("ce", 64 // ce_chunk(64))
flags.set_unroll("ssd", 64 // cfg.ssm.chunk)
flags.set_unroll("micro", 2)
lowered = dryrun.lower_cell(cfg, shape, mesh, knobs, policy="tp", n_micro=2,
                            remat="full")
compiled = lowered.compile()
cost = compiled.cost_analysis()
cost = cost[0] if isinstance(cost, (list, tuple)) else cost
text = compiled.as_text()
shapes = {m.group(1): [int(d) for d in m.group(2).split(",") if d]
          for m in re.finditer(r"%([\w.\-]+)\s*=\s*\w+\[([\d,]*)\]", text)}
dots = 0.0
for m in re.finditer(r"=\s*\w+\[([\d,]*)\]\S*\s+dot\(%([\w.\-]+), %[\w.\-]+\)"
                     r".*?lhs_contracting_dims=\{([\d,]*)\}", text):
    n = 1
    for d in m.group(1).split(","):
        n *= int(d) if d else 1
    k = 1
    for d in m.group(3).split(","):
        k *= shapes[m.group(2)][int(d)] if d else 1
    dots += 2.0 * n * k
out["cell"] = dict(
    calibrated=flops, flops=float(cost["flops"]), dots=dots,
    arg=int(compiled.memory_analysis().argument_size_in_bytes),
    coll=roofline.collective_bytes(text), whiles=text.count(" while("))

# bookkeeping
out["variants"] = {k: None if v is None else dataclasses.asdict(v)
                   for k, v in dryrun.VARIANTS.items()}
out["topk_half"] = dataclasses.asdict(dryrun.resolve_variant(
    "topk_half", get_config("olmoe-1b-7b")))
out["skip_shape"] = dryrun.run_cell("phi4-mini-3.8b", "long_500k", "pod",
                                    "precise")
dryrun.make_production_mesh = lambda multi_pod=False: make_mesh(
    (2, 4), ("data", "model"))
out["skip_gint8"] = dryrun.run_cell("mamba2-780m-smoke", "train_4k", "pod",
                                    "gint8")

print("JAXOUT" + json.dumps(out))
'''

# decode pricing as the JAX serving driver runs it, on one host device
# (XLA's CPU count of the compiled decode cell moves with the forced host
# device count: 0.0700 with 8 against 0.1085 with 1 at this cell): the
# share, the ring numerator (the compiled bytes set to 2**60, so the share
# is ring / 2**60 exactly) and the paged driver's table
JAX_DECODE = r'''
import json
import jax
from repro.configs import get_config
from repro.core import explorer
from repro.launch.serve import serving_table
pcfg = get_config("phi4-mini-3.8b-smoke")
out = {"share": explorer.decode_kv_share(pcfg, 4, 64)}
real = jax.stages.Compiled.cost_analysis
jax.stages.Compiled.cost_analysis = lambda self: {"bytes accessed": 2.0 ** 60}
out["ring"] = explorer.decode_kv_share(pcfg, 4, 64) * 2.0 ** 60
jax.stages.Compiled.cost_analysis = real
out["table"] = [(v.name, v.rel_time) for v in serving_table(
    pcfg, slots=4, max_len=64, page_occupancy=0.5,
    price_from_compile=True).variants]
print("JAXOUT" + json.dumps(out))
'''


@pytest.fixture(scope="module")
def jax_side(subproc):
    out = subproc(f"SYNTH = {SYNTH_HLO!r}\n" + JAX_SIDE, devices=8,
                  timeout=600)
    return json.loads(out.split("JAXOUT", 1)[1])


@pytest.fixture(scope="module")
def jax_decode(subproc):
    out = subproc(JAX_DECODE, devices=1, timeout=300)
    return json.loads(out.split("JAXOUT", 1)[1])


def _cell():
    cfg = get_config("mamba2-780m-smoke")
    return cfg, ShapeConfig("t", 64, 8, "train"), make_mesh(
        (2, 4), ("data", "model"), "meta")


@pytest.fixture(scope="module")
def port_cell():
    torch.set_num_threads(1)
    cfg, shape, mesh = _cell()
    return dryrun.trace_cell(cfg, shape, mesh, dryrun.PRECISE, policy="tp",
                             n_micro=2, remat="full")


def test_collective_parser_twin(jax_side):
    """The HLO parser's payloads as records: the same bytes by kind."""
    recs = [cost.CollectiveRecord(kind, payload, "model", 4, 0.0, "owned")
            for kind, payload in (
                ("all-gather", 2048 * 1024 * 2), ("all-reduce", 4096 * 4),
                ("reduce-scatter", 4096 * 4), ("all-to-all", 64 * 128),
                ("collective-permute", 32 * 32 * 2))]
    assert roofline.collective_bytes(recs) == jax_side["parser"]


def test_argument_bytes_equal_jax(jax_side, port_cell):
    assert port_cell["argument_bytes"] == jax_side["cell"]["arg"]


def test_flops_within_tolerance_of_unrolled_compile(jax_side, port_cell):
    j = jax_side["cell"]
    assert j["whiles"] == 0          # every loop unrolled
    ops = port_cell["ops"]
    products = sum(ops[k][1] for k in ("mm", "bmm", "addmm", "baddbmm")
                   if k in ops) + sum(
        k["flops"] for k in port_cell["kernels"].values())
    ratio = port_cell["flops"] / j["flops"]
    print(f"FLOPs a position: port {port_cell['flops']:.4e}, JAX unrolled "
          f"{j['flops']:.4e} (ratio {ratio:.4f}), JAX calibrated "
          f"{j['calibrated']:.4e}; products port {products:.4e}, JAX dots "
          f"{j['dots']:.4e}")
    assert abs(products - j["dots"]) <= 0.10 * j["dots"]
    assert 0.55 <= ratio <= 1.10, ratio


def test_collective_bytes_by_kind(jax_side, port_cell):
    port, jax = port_cell["collectives"], jax_side["cell"]["coll"]
    print(f"collectives by kind: port {port}, JAX {jax}; the port's by "
          f"source {port_cell['collectives_by_source']}")
    assert set(port) <= set(jax)
    assert port.get("all-reduce", 0) > 0
    ratio = sum(port.values()) / sum(jax.values())
    assert 0.5 <= ratio <= 1.5, ratio


def test_variants_and_skips_equal_jax(jax_side, tmp_path):
    assert {k: None if v is None else dataclasses.asdict(v)
            for k, v in dryrun.VARIANTS.items()} == jax_side["variants"]
    assert dataclasses.asdict(dryrun.resolve_variant(
        "topk_half", get_config("olmoe-1b-7b"))) == jax_side["topk_half"]
    assert dryrun.run_cell("phi4-mini-3.8b", "long_500k", "pod",
                           "precise") == jax_side["skip_shape"]
    assert dryrun.run_cell("mamba2-780m-smoke", "train_4k", "pod", "gint8",
                           mesh=make_mesh((2, 4), ("data", "model"),
                                          "meta")) == jax_side["skip_gint8"]


def _jax_artifact_keys():
    """The keys the JAX package's ``run_cell`` writes, read from its
    source (the ``art`` literal and ``art.update``)."""
    tree = ast.parse((REPO / "src/repro/launch/dryrun.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "run_cell")
    dicts = [n.value for n in ast.walk(fn) if isinstance(n, ast.Assign)
             and getattr(n.targets[0], "id", "") == "art"]
    dicts += [n.args[0] for n in ast.walk(fn) if isinstance(n, ast.Call)
              and getattr(n.func, "attr", "") == "update"
              and getattr(n.func.value, "id", "") == "art"]
    return {k.value for d in dicts for k in d.keys
            if isinstance(k, ast.Constant)}


def test_run_cell_writes_jax_keys(tmp_path):
    cfg, shape, mesh = _cell()
    art = dryrun.run_cell("mamba2-780m-smoke", "t", "pod", "int8", cfg=cfg,
                          shape=shape, mesh=mesh, out_dir=str(tmp_path),
                          tag="twin")
    written = json.loads((tmp_path / "mamba2-780m-smoke__t__pod__int8__twin"
                                      ".json").read_text())
    want = _jax_artifact_keys() - {"lower_s", "compile_s"} | {"trace_s"}
    assert "flops" in want and "roofline_fraction" in want
    assert want <= set(written), want - set(written)
    assert written["probes"] == {} and written == json.loads(json.dumps(art))
    assert written["compute_dtype"] == "int8"
    assert written["kernels"]["int8_matmul[A]"]["launches"] > 0


def test_decode_kv_share_twin(jax_decode):
    from repro_torch.core import explorer
    cfg = get_config("phi4-mini-3.8b-smoke")
    assert explorer.decode_ring_bytes(cfg, 4, 64, 4) == jax_decode["ring"]
    share = explorer.decode_kv_share(cfg, 4, 64)
    print(f"decode_kv_share: port {share:.4f}, JAX {jax_decode['share']:.4f}")
    assert abs(share - jax_decode["share"]) <= 0.30 * jax_decode["share"]


def test_paged_driver_prices_from_the_trace(jax_decode, monkeypatch):
    """The paged driver's table: JAX's rungs in order, each ``rel_time``
    within 3% of JAX's; the driver asks for the traced pricing, as JAX's
    asks for the compiled one."""
    from repro_torch.launch import serve
    cfg = get_config("phi4-mini-3.8b-smoke")
    table = serve.serving_table(cfg, slots=4, max_len=64,
                                page_occupancy=0.5, price_from_compile=True)
    got = [(v.name, v.rel_time) for v in table.variants]
    assert [n for n, _ in got] == [n for n, _ in jax_decode["table"]]
    for (_, a), (_, b) in zip(got, jax_decode["table"]):
        assert abs(a - b) <= 0.03 * b, (got, jax_decode["table"])
    seen = {}

    class Stop(Exception):
        pass

    def spy(cfg, **kw):
        seen.update(kw)
        raise Stop
    monkeypatch.setattr(serve, "serving_table", spy)
    with pytest.raises(Stop):
        serve.main(["--arch", "phi4-mini-3.8b-smoke", "--paged",
                    "--device", "cpu", "--slots", "4", "--max-len", "64"])
    assert seen["price_from_compile"] is True


JAX_PRODUCTION = r'''
import json
from repro.launch import dryrun    # forces 512 host devices before jax
out = {}
for arch, shape in (("mamba2-780m", "train_4k"),
                    ("phi4-mini-3.8b", "decode_32k")):
    out[arch] = dryrun.run_cell(arch, shape, "pod", "precise", out_dir=OUT)
print("JAXOUT" + json.dumps(out))
'''


def test_production_cells_match_jax(subproc, tmp_path):
    """Two of the JAX dry-run's production cells on its 256-device mesh
    against the port's one-position traces: argument and alias bytes
    exact; mamba2-780m train_4k's FLOPs within 0.8–1.25 of JAX's
    loop-calibrated count (the SSD and elementwise differences of queue 3
    item 19, at full width)."""
    out = subproc(f"OUT = {str(tmp_path)!r}\n" + JAX_PRODUCTION,
                  timeout=600)
    jax = json.loads(out.split("JAXOUT", 1)[1])
    for arch, shape in (("mamba2-780m", "train_4k"),
                        ("phi4-mini-3.8b", "decode_32k")):
        port = dryrun.run_cell(arch, shape, "pod", "precise", write=False)
        j = jax[arch]
        print(f"{arch} {shape}: FLOPs port {port['flops']:.4e} JAX "
              f"{j['flops']:.4e}; bytes port {port['bytes_accessed']:.4e} "
              f"JAX {j['bytes_accessed']:.4e}; collectives port "
              f"{port['collectives']} JAX {j['collectives']}")
        assert port["argument_bytes"] == j["argument_bytes"]
        assert port["alias_bytes"] == j["alias_bytes"]
        if shape == "train_4k":
            assert 0.8 <= port["flops"] / j["flops"] <= 1.25


def test_production_cells_trace_on_meta(tmp_path):
    """The CLI's cells on the CPU: mamba2-780m train_4k on pod and the pod
    syncs on multipod write JAX's keys; nothing touches CUDA."""
    art = dryrun.main(["--arch", "mamba2-780m", "--shape", "train_4k",
                       "--mesh", "pod", "--out", str(tmp_path)])
    assert art["n_chips"] == 256 and art["mesh_shape"] == {"data": 16,
                                                            "model": 16}
    assert art["parts_split"] == ["ssm"]        # 50280 does not split 16
    assert art["kernels"]["ssd_scan[-]"]["launches"] == 96
    assert art["argument_bytes"] > 0 and art["dominant"] in (
        "compute", "memory", "collective")
    for compress in (False, True):
        sync = dryrun.main(["--arch", "mamba2-780m", "--pod-sync",
                            "--out", str(tmp_path)]
                           + (["--compress"] if compress else []))
        assert set(sync["collectives"]) == (
            {"all-gather"} if compress else {"all-reduce"})
    assert len(list(tmp_path.glob("*.json"))) == 3
    assert not torch.cuda.is_initialized()
