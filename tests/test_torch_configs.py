"""Twin of ``tests/test_configs.py`` for the port's config registry: the
ten archs' assigned dims, the analytic parameter counts in their bands,
the MoE knobs, the 40-cell grid with its 34 runnable cells, every smoke
config's ``param_count`` equal to the port's own init (``models/api.py``),
and the shapes registry. The expected values are the JAX test's, imported
from it so the two cannot drift apart."""
import pytest
import torch

from repro_torch.configs import ARCHS, SHAPES, all_cells, get_config
from repro_torch.models import api
from tests.test_configs import ASSIGNED, EXPECTED_BILLIONS


def test_registry_holds_the_ten_archs():
    import repro.configs as jax_configs
    assert list(ARCHS) == list(jax_configs.ARCHS)
    assert len(ARCHS) == 10


@pytest.mark.parametrize("name", list(ARCHS))
def test_assigned_dims(name):
    cfg = ARCHS[name]
    for field, val in ASSIGNED[name].items():
        assert getattr(cfg, field) == val, (name, field)


@pytest.mark.parametrize("name", list(ARCHS))
def test_param_count_in_band(name):
    lo, hi = EXPECTED_BILLIONS[name]
    n = ARCHS[name].param_count() / 1e9
    assert lo <= n <= hi, (name, n)


def test_moe_knobs():
    assert ARCHS["olmoe-1b-7b"].moe.n_experts == 64
    assert ARCHS["olmoe-1b-7b"].moe.top_k == 8
    assert ARCHS["moonshot-v1-16b-a3b"].moe.top_k == 6


def test_cell_grid():
    cells = list(all_cells())
    assert len(cells) == 40
    runnable = [c for c in cells if c[2]]
    assert len(runnable) == 34
    skipped = {(a.name, s.name) for a, s, ok, _ in cells if not ok}
    assert all(s == "long_500k" for _, s in skipped)
    assert ("mamba2-780m", "long_500k") not in skipped
    assert ("zamba2-2.7b", "long_500k") not in skipped
    assert ("gemma3-12b", "long_500k") not in skipped
    assert ("gemma2-27b", "long_500k") not in skipped


@pytest.mark.parametrize("name", list(ARCHS))
def test_smoke_config_param_count_matches_init(name):
    """The port's ``api.init`` of the smoke config (the encoder-decoder's
    ``enc`` and ``dec`` lists, the vlm's decoder, zamba2's shared block
    counted once) holds exactly ``param_count`` parameters."""
    cfg = get_config(name + "-smoke")
    params = api.init(cfg, 0, torch.float32, "cpu")
    n = sum(p.numel() for p in params.parameters())
    assert n == cfg.param_count()


def test_shapes_registry():
    assert SHAPES["train_4k"].seq_len == 4096
    assert SHAPES["train_4k"].global_batch == 256
    assert SHAPES["prefill_32k"].global_batch == 32
    assert SHAPES["decode_32k"].kind == "decode"
    assert SHAPES["long_500k"].seq_len == 524288
