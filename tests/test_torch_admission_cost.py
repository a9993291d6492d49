"""The port's admission pricing against the JAX package's, on the CPU:
``roofline.admission_terms``, ``roofline.decode_min_bytes`` and
``explorer.admission_cost``.

The FLOP and byte terms are exactly the JAX functions' for phi4-mini-3.8b,
gemma2-27b (local layers) and zamba2-2.7b (Mamba and shared attention), at
1 and 4 shards, with and without ``kv_quant``; the seconds are those terms
at the H100's 989 bf16 TFLOP/s and 3.35 TB/s; ``admission_cost``'s
``n_shards`` and ``reason`` are ``prefill_plan``'s (and the JAX
function's, with its kernel on). The plans read only ``mesh.shape``, so
both packages take the same ``_FakeMesh``."""
import pytest

from repro import roofline as jax_roofline
from repro.configs import get_config as jax_config
from repro.configs.base import ShapeConfig as JaxShape
from repro.core import explorer as jax_explorer
from repro_torch import roofline
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import explorer
from repro_torch.dist.sharding import prefill_plan

ARCHS = ["phi4-mini-3.8b", "gemma2-27b", "zamba2-2.7b"]


class _FakeMesh:
    def __init__(self, shape):
        self.shape = shape


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("n_shards", [1, 4])
@pytest.mark.parametrize("kv_quant", [False, True])
def test_admission_terms_match_jax(arch, n_shards, kv_quant):
    cfg, jcfg = get_config(arch), jax_config(arch)
    for chunk, kv in ((512, 4096), (2048, 16384), (128, 700)):
        got = roofline.admission_terms(cfg, chunk, kv, n_shards=n_shards,
                                       kv_quant=kv_quant)
        want = jax_roofline.admission_terms(jcfg, chunk, kv,
                                            n_shards=n_shards,
                                            kv_quant=kv_quant)
        assert got["flops_per_device"] == want["flops_per_device"]
        assert got["hbm_bytes_per_device"] == want["hbm_bytes_per_device"]
        assert got["flops_per_device"] > 0
        assert got["compute_s"] == got["flops_per_device"] / 989e12
        assert got["memory_s"] == got["hbm_bytes_per_device"] / 3.35e12


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kv_quant", [False, True])
def test_decode_min_bytes_match_jax(arch, kv_quant):
    cfg, jcfg = get_config(arch), jax_config(arch)
    for seq, batch, chips in ((4096, 8, 1), (32768, 4, 4)):
        got = roofline.decode_min_bytes(
            cfg, ShapeConfig("d", seq, batch, "decode"), chips, kv_quant)
        want = jax_roofline.decode_min_bytes(
            jcfg, JaxShape("d", seq, batch, "decode"), chips, kv_quant)
        assert got == want


_MESHES = [None, {"data": 4}, {"data": 4, "model": 2},
           {"pod": 2, "data": 2}, {"model": 4}, {"data": 8}]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", _MESHES, ids=str)
def test_admission_cost_matches_prefill_plan(arch, shape):
    cfg, jcfg = get_config(arch), jax_config(arch)
    mesh = None if shape is None else _FakeMesh(shape)
    for chunk in (512, 4):
        got = explorer.admission_cost(cfg, mesh, chunk, 4096,
                                      use_kernel=True)
        want = jax_explorer.admission_cost(jcfg, mesh, chunk, 4096,
                                           use_kernel=True)
        plan, reason = prefill_plan(cfg, mesh, chunk)
        assert got["n_shards"] == (plan.n_shards if plan else 1)
        assert got["reason"] == reason == want["reason"]
        for k in ("n_shards", "flops_per_device", "hbm_bytes_per_device"):
            assert got[k] == want[k], k
    if mesh is not None:
        off = explorer.admission_cost(cfg, mesh, 512, 4096,
                                      use_kernel=False)
        assert off["n_shards"] == 1
        assert off["reason"] == "kernel off: no CUDA device"
        # no card here: the default is the kernel off
        assert explorer.admission_cost(cfg, mesh, 512, 4096) == off
