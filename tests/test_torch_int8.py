"""The port's int8 matmul path against the JAX package, on the CPU: the
K-major weight layout (``quantize_weight``, ``int8_matmul_t``), the rule
that picks one of the kernel's designs, the weight cache of
``ops.quantized_matmul`` and the serving engine across swaps in and out of
the int8 rungs.

The CUDA designs run only on the card (``chip_smoke.py`` holds each to the
plain version bit for bit); here the wrappers run the plain version, and
the integer sums are exact, so every comparison is exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.kernels import int8_matmul as jax_i8
from repro.kernels import ref as jax_ref
from repro.launch.serve import serving_table as jax_serving_table
from repro.models import api as jax_api
from repro.serve import engine as jax_engine
from repro_torch import configs as t_configs
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import int8_matmul as t_i8
from repro_torch.kernels import ops
from repro_torch.kernels import ref as t_ref
from repro_torch.launch.serve import serving_table
from repro_torch.models.lm import init_lm
from repro_torch.serve import engine as t_engine

ARCH = "phi4-mini-3.8b-smoke"


def _weight(K, N, dtype, seed):
    """A weight with a zero column (the 1e-8 clamp) and a column whose
    largest magnitude appears twice, once negative."""
    w = np.random.default_rng(seed).normal(size=(K, N)) / np.sqrt(K)
    w[:, 0] = 0.0
    w[1, 1], w[K - 1, 1] = 3.0, -3.0
    return torch.tensor(w, dtype=torch.float32).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("K,N", [(64, 48), (3072 // 16, 160), (5, 3)])
def test_quantize_weight_is_the_columnwise_quantization_transposed(K, N,
                                                                   dtype):
    w = _weight(K, N, dtype, seed=K + N)
    w_t, w_s = ops.quantize_weight(w)
    assert w_t.shape == (N, K) and w_t.is_contiguous()
    assert w_s.shape == (N, 1) and w_s.dtype == torch.float32
    q0, s0 = t_ref.quantize_rowwise(w, axis=0)
    assert torch.equal(w_t, q0.t()) and torch.equal(w_s, s0.t())
    jw = jnp.asarray(w.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    jq, js = jax_ref.quantize_rowwise(jw, axis=0)
    np.testing.assert_array_equal(w_t.numpy(), np.asarray(jq).T)
    np.testing.assert_array_equal(w_s.numpy(), np.asarray(js).T)


def _operands(M, K, N, seed):
    rng = np.random.default_rng(seed)
    x_q = rng.integers(-127, 128, (M, K), dtype=np.int8)
    w_t = rng.integers(-127, 128, (N, K), dtype=np.int8)
    xs = (rng.random((M, 1)) * 1e-2 + 1e-4).astype(np.float32)
    ws = (rng.random((N, 1)) * 1e-2 + 1e-4).astype(np.float32)
    return x_q, xs, w_t, ws


@pytest.mark.parametrize("M,K,N", [(1, 64, 48), (8, 3072, 40), (16, 48, 33),
                                   (17, 160, 24), (5, 3000, 100),
                                   (130, 272, 9)])
def test_int8_matmul_t_matches_jax_ref(M, K, N):
    """Ragged shapes that each design and the fallback take on the card:
    exact against ``int8_matmul_ref`` on the transposed weight, bf16 and
    fp32 outputs."""
    x_q, xs, w_t, ws = _operands(M, K, N, seed=M * K)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        want = jax_ref.int8_matmul_ref(jnp.asarray(x_q), jnp.asarray(xs),
                                       jnp.asarray(w_t.T), jnp.asarray(ws.T),
                                       out_dtype=jdt)
        got = t_i8.int8_matmul_t(*map(torch.from_numpy, (x_q, xs, w_t, ws)),
                                 out_dtype=tdt)
        assert got.dtype == tdt and got.shape == (M, N)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want).astype(np.float32))


def test_int8_matmul_t_matches_pallas_interpret():
    """Exact: int32 sums stay below 2^24 here, where the Pallas kernel's
    fp32 block sums are exact too."""
    x_q, xs, w_t, ws = _operands(8, 256, 128, seed=3)
    want = jax_i8.int8_matmul(jnp.asarray(x_q), jnp.asarray(xs),
                              jnp.asarray(w_t.T), jnp.asarray(ws.T), bk=128,
                              out_dtype=jnp.float32, interpret=True)
    got = t_i8.int8_matmul_t(*map(torch.from_numpy, (x_q, xs, w_t, ws)),
                             out_dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("M,K,want", [
    (1, 3072, "B"), (8, 3072, "B"), (16, 8192, "B"), (17, 3072, "A"),
    (128, 3072, "A"), (2048, 8192, "A"), (8192, 1536, "A"),
    (5, 3000, "fallback"), (8192, 3000, "fallback"), (4, 8, "fallback"),
    (4, 0, "fallback")])
def test_select_design(M, K, want):
    assert t_i8.select_design(M, 3072, K) == want


@pytest.mark.parametrize("M,N,want", [
    (128, 8192, 128), (2048, 3072, 128), (2048, 8192, 256),
    (4096, 1536, 128), (4096, 3072, 256), (8192, 3072, 256),
    (8192, 8192, 256)])
def test_tile_n(M, N, want):
    """256-wide tiles where they still make two waves on 132 SMs."""
    assert t_i8.tile_n(M, N) == want


def test_cpu_tensors_launch_nothing():
    before = (t_i8.launches, dict(t_i8.design_launches))
    x_q, xs, w_t, ws = map(torch.from_numpy, _operands(4, 32, 8, seed=1))
    t_i8.int8_matmul_t(x_q, xs, w_t, ws)
    t_i8.int8_matmul(x_q, xs, w_t.t(), ws.t())
    assert (t_i8.launches, t_i8.design_launches) == before


# ---------------------------------------------------------- weight cache --

@pytest.fixture
def empty_cache():
    ops.clear_weight_cache()
    yield ops._weight_cache
    ops.clear_weight_cache()


def test_cache_hit_returns_the_same_tensors(empty_cache):
    w = _weight(64, 48, torch.float32, seed=0)
    a = ops.cached_weight(w)
    b = ops.cached_weight(w)
    assert a[0] is b[0] and a[1] is b[1] and len(empty_cache) == 1
    want = ops.quantize_weight(w)
    assert torch.equal(a[0], want[0]) and torch.equal(a[1], want[1])


def test_in_place_update_misses(empty_cache):
    w = _weight(64, 48, torch.float32, seed=1)
    a = ops.cached_weight(w)
    w.add_(0.5)
    b = ops.cached_weight(w)
    assert b[0] is not a[0] and len(empty_cache) == 1
    want = ops.quantize_weight(w)
    assert torch.equal(b[0], want[0]) and torch.equal(b[1], want[1])
    assert not torch.equal(a[1], b[1])


def test_layer_view_of_a_stack_hits_and_shares_the_version(empty_cache):
    """Two view objects of one layer of a stacked weight hit one entry; an
    in-place update of the stack (the view shares its counter) misses."""
    stack = torch.stack([_weight(32, 16, torch.float32, seed=s)
                         for s in range(3)])
    a = ops.cached_weight(stack[1])
    assert ops.cached_weight(stack[1])[0] is a[0]
    assert ops.cached_weight(stack[2])[0] is not a[0]
    assert len(empty_cache) == 2
    stack.mul_(2.0)
    b = ops.cached_weight(stack[1])
    assert b[0] is not a[0]
    assert torch.equal(b[1], ops.quantize_weight(stack[1])[1])


def test_training_products_never_cache(empty_cache):
    """Under autograd every call quantises the weight (the scales' gradient
    needs its graph); without autograd the same weight caches."""
    w = _weight(64, 48, torch.float32, seed=2).requires_grad_(True)
    x = torch.tensor(np.random.default_rng(3).normal(size=(5, 64)),
                     dtype=torch.float32)
    for _ in range(2):
        ops.quantized_matmul(x, w).sum().backward()
    assert w.grad is not None and not empty_cache
    with torch.no_grad():
        ops.quantized_matmul(x, w)
    assert len(empty_cache) == 1


def _autograd_reference(x, w):
    """The W8A8 product through the plain ops under autograd: what the
    port computed before ``_QuantizedMatmul``, and what ``jax.grad`` of
    ``quantized_matmul_ref`` is held to."""
    x_q, x_s = t_ref.quantize_rowwise(x)
    w_q, w_s = t_ref.quantize_rowwise(w, axis=0)
    return t_ref.int8_matmul_ref(x_q, x_s, w_q, w_s, x.dtype)


@pytest.mark.parametrize("M,K,N", [(6, 64, 48), (1, 16, 8), (33, 80, 5)])
def test_quantized_matmul_grads_equal_autograd_through_the_ops(M, K, N):
    """``_QuantizedMatmul``'s forward and both gradients equal autograd
    through ``quantize_rowwise`` and ``int8_matmul_ref`` bit for bit, with
    ties for the largest magnitude, a zero row of x and a zero column of
    w."""
    rng = np.random.default_rng(M + K + N)
    x = rng.normal(size=(M, K)).astype(np.float32)
    x[0, 1], x[0, K - 1] = 4.0, -4.0
    if M > 1:
        x[1] = 0.0
    w = _weight(K, N, torch.float32, seed=N).numpy()
    g = rng.normal(size=(M, N)).astype(np.float32)
    got, want = [], []
    for fn, out in ((ops.quantized_matmul, got), (_autograd_reference, want)):
        xt = torch.from_numpy(x).requires_grad_(True)
        wt = torch.from_numpy(w).requires_grad_(True)
        y = fn(xt, wt)
        out += [y.detach(), *torch.autograd.grad(y, (xt, wt),
                                                 torch.from_numpy(g))]
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert got[1].abs().sum() > 0 and got[2].abs().sum() > 0


def test_quantize_rows_is_the_plain_quantization():
    from repro_torch.kernels import quantize_rows as qr
    x = _weight(40, 24, torch.bfloat16, seed=7)
    before = qr.launches
    for a, b in zip(qr.quantize_rows(x), t_ref.quantize_rowwise(x)):
        assert torch.equal(a, b)
    assert qr.launches == before
    from _torch_elsewhere import elsewhere
    with pytest.raises(ValueError):
        qr.quantize_rows(elsewhere(torch.empty((2, 4))))


def test_dead_weights_leave_the_cache(empty_cache):
    w = _weight(64, 48, torch.float32, seed=4)
    ops.cached_weight(w)
    del w
    ops.cached_weight(_weight(32, 8, torch.float32, seed=5))
    assert len(empty_cache) == 1


def test_quantized_matmul_with_cache_matches_jax_ref(empty_cache):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 3, 64)).astype(np.float32)
    w = torch.from_numpy((rng.normal(size=(64, 48)) / 8).astype(np.float32))
    want = np.asarray(jax_ref.quantized_matmul_ref(jnp.asarray(x),
                                                   jnp.asarray(w.numpy())))
    for _ in range(2):                       # a miss, then a hit
        got = ops.quantized_matmul(torch.from_numpy(x), w)
        np.testing.assert_array_equal(got.numpy(), want)
    assert len(empty_cache) == 1


def test_set_variant_away_from_int8_empties_the_cache(empty_cache):
    cfg = t_configs.get_config(ARCH)
    table = serving_table(cfg, slots=2, max_len=32, page_occupancy=0.5)
    names = [v.name for v in table.variants]
    eng = t_engine.ServeEngine(cfg, params=init_lm(cfg, 0, torch.float32,
                                                   "cpu"),
                               table=table, batch_slots=2, max_len=32,
                               prefill_chunk=4, paged=True, page_size=4,
                               device="cpu")
    eng.set_variant(names.index("int8"))
    eng.submit(t_engine.Request(0, prompt=[3, 5, 7, 9, 11], max_new=3))
    eng.run()
    assert len(empty_cache) == 3 * cfg.n_layers     # the MLPs' weights
    eng.set_variant(names.index("int8+kvq8"))       # still int8 matmuls
    assert len(empty_cache) == 3 * cfg.n_layers
    eng.set_variant(names.index("precise"))
    assert not empty_cache


# ------------------------------------------------- engine across swaps --

@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = jax_configs.get_config(ARCH), t_configs.get_config(ARCH)
    jparams = jax_api.init(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg)
    kw = dict(slots=3, max_len=32, page_occupancy=0.5)
    return (jcfg, tcfg, jparams, tparams, jax_serving_table(jcfg, **kw),
            serving_table(tcfg, **kw))


def test_streams_identical_across_int8_precise_int8(model, empty_cache,
                                                    monkeypatch):
    """int8 -> precise -> int8 mid-run, with decoders live across each
    swap: the port's greedy streams equal the JAX engine's token for
    token, every weight is quantised once per activation of the int8
    rungs, and the swap to precise empties the cache."""
    jcfg, tcfg, jparams, tparams, jtable, ttable = model
    kw = dict(batch_slots=3, max_len=32, prefill_chunk=4, page_size=4,
              n_pages=24)
    je = jax_engine.ServeEngine(jcfg, params=jparams, table=jtable,
                                paged=True, **kw)
    te = t_engine.ServeEngine(tcfg, params=tparams, table=ttable,
                              paged=True, device="cpu", **kw)
    made = []
    quantize = ops.quantize_weight
    monkeypatch.setattr(ops, "quantize_weight",
                        lambda w: made.append(1) or quantize(w))
    rng = np.random.default_rng(12)
    prompts = [[int(t) for t in rng.integers(1, tcfg.vocab_size, n)]
               for n in (6, 11, 4, 9, 13)]
    for eng, mod in ((je, jax_engine), (te, t_engine)):
        eng.reqs = [mod.Request(i, prompt=p, max_new=8)
                    for i, p in enumerate(prompts)]
        for r in eng.reqs:
            eng.submit(r)
    int8 = [v.name for v in ttable.variants].index("int8")
    walk, next_at, seen = [int8, 0, int8], 0, []
    for step in range(200):
        if je.idle and te.idle:
            break
        assert je.idle == te.idle, step
        if walk and step >= next_at:
            if te.active_variant == walk[0]:
                seen.append((walk.pop(0), len(made), len(empty_cache)))
                next_at = step + 4
            else:
                je.request_variant(walk[0])
                te.request_variant(walk[0])
        je.step()
        te.step()
        assert je.active_variant == te.active_variant, step
    assert not walk, f"run ended before the swaps to {walk}"
    # when precise took over, the first activation's int8 weights had been
    # made once each and were gone; the second activation made them again
    per_activation = 3 * tcfg.n_layers
    assert seen[1][1:] == (per_activation, 0), seen
    assert len(made) == 2 * per_activation, seen
    assert len(empty_cache) == per_activation
    jout = {r.uid: r.out for r in je.reqs}
    tout = {r.uid: r.out for r in te.reqs}
    assert all(len(r.out) == r.max_new for r in te.reqs)
    assert tout == jout
