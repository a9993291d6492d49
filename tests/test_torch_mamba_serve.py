"""The port's Mamba serving against the JAX package's, on the CPU, on
mamba2-780m-smoke in fp32 with the same weights (``repro.models.api.init``
carried over by ``repro_torch.convert``).

The scan with a state in and out: ``ssd_scan_plain`` and
``ssd_passes_plain`` from an initial state with the final state out
against ``ssd_chunked_ref(init_state=, return_state=True)``, and the
padding rule of ``ssd_scan_state`` (a ragged length padded with x = 0,
dt = 0, b = c = 0 to the kernels' chunks) against the unpadded call at the
JAX package's chunk. The mixer: ``mamba_prefill`` chunk after chunk and
``mamba_decode`` (with the ``active`` mask, in place) against the JAX
package's. Then the mamba2 cases of the serving families: the paged and
the dense engine and the megastep at K 1, 4 and 16 on every serving rung
(tests/test_paged.py, test_megastep.py, test_serve_admission.py),
mid-run admission (test_continuous.py), the EOS megastep, a swap across
``kv_quant`` with requests mid-decode, ``prefill_with_cache``
(test_prefill.py), ``insert_request`` and ``convert_caches`` on Mamba rows
(test_slots_convert.py) and a training step (test_models_smoke.py).
Greedy streams are equal token for token; logits, conv tails and SSM
states agree within ``ATOL`` (1e-4: fp32 sums in other orders), the scan
within 1e-5 of its largest output."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.models import common as jax_common
from repro.models import mamba2 as jax_mamba
from repro.serve import slots as jax_slots
from repro_torch.convert import caches_to_numpy
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as t_ssd
from repro_torch.models import lm as t_lm
from repro_torch.models import mamba2 as t_mamba
from repro_torch.models.common import ParamTree
from repro_torch.serve import slots as t_slots
from tests import _torch_ssm_twins as tw

ARCH = "mamba2-780m-smoke"
SCAN_TOL = 1e-5         # of the largest |y| or |state|: fp32 reassociation


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's ops here are tiny: one intra-op thread runs them faster
    than a pool that contends with the other test workers' for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------- the scan with a state --

def _scan_inputs(S, H=4, P=8, N=16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(2, S, H)) - 2.0)).astype(
        np.float32)
    a = -rng.uniform(1.0, 8.0, size=(H,)).astype(np.float32)
    b = (rng.normal(size=(2, S, N)) * N ** -0.5).astype(np.float32)
    c = (rng.normal(size=(2, S, N)) * N ** -0.5).astype(np.float32)
    s0 = rng.normal(size=(2, H, P, N)).astype(np.float32)
    return x, dt, a, b, c, s0


_REF = {}


def jax_scan(x, dt, a, b, c, chunk, init=None, d_skip=None):
    """``ssd_chunked_ref`` with the state out, jitted once a shape."""
    key = (x.shape, chunk, init is None, d_skip is None)
    if key not in _REF:
        _REF[key] = jax.jit(lambda *t: jax_ref.ssd_chunked_ref(
            *t[:5], chunk=chunk, init_state=t[5], d_skip=t[6],
            return_state=True))
    return _REF[key](*map(jnp.asarray, (x, dt, a, b, c)),
                     None if init is None else jnp.asarray(init),
                     None if d_skip is None else jnp.asarray(d_skip))


def _close(got, want, tol=SCAN_TOL):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * float(np.abs(want).max()))


@pytest.mark.parametrize("S,chunk", [(32, 8), (48, 16), (12, 12)])
@pytest.mark.parametrize("fn", ["ssd_scan_plain", "ssd_passes_plain"])
def test_scan_state_in_and_out_matches_jax(fn, S, chunk):
    """From an initial state, the final state out: y and the state equal
    ``ssd_chunked_ref``'s; with no initial state, the zero-state run's."""
    x, dt, a, b, c, s0 = _scan_inputs(S)
    y, st = getattr(t_ssd, fn)(*map(torch.from_numpy, (x, dt, a, b, c)),
                               chunk=chunk, init_state=torch.from_numpy(s0),
                               return_state=True)
    jy, js = jax_scan(x, dt, a, b, c, chunk, s0)
    _close(y, jy)
    _close(st, js)
    y0, st0 = getattr(t_ssd, fn)(*map(torch.from_numpy, (x, dt, a, b, c)),
                                 chunk=chunk, return_state=True)
    jy0, js0 = jax_scan(x, dt, a, b, c, chunk, np.zeros_like(s0))
    _close(y0, jy0)
    _close(st0, js0)


@pytest.mark.parametrize("S,want_q,want_pad", [(1, 4, 4), (3, 4, 4),
                                               (44, 44, 44), (45, 48, 48),
                                               (128, 128, 128),
                                               (130, 128, 256),
                                               (300, 128, 384)])
def test_state_chunk_rule(S, want_q, want_pad):
    """The kernels' chunk for a state call: a multiple of 4 in [4, 128]; a
    shorter sequence is one chunk of its length rounded up to 4."""
    assert t_ssd.state_chunk(S, 128) == (want_q, want_pad)


@pytest.mark.parametrize("S", [1, 3, 45, 130])
def test_padding_matches_unpadded_call(S):
    """``ssd_scan_state`` pads a ragged length with zero tokens; y and the
    final state equal the unpadded call at the JAX package's chunk (the
    largest divisor of S at most 128, as ``mamba_prefill`` takes it) in
    the port's plain version and in ``ssd_chunked_ref``."""
    x, dt, a, b, c, s0 = _scan_inputs(S, seed=S)
    q = min(128, S)
    while S % q:
        q -= 1
    t = [torch.from_numpy(v) for v in (x, dt, a, b, c)]
    y, st = t_ssd.ssd_scan_state(*t, chunk=128,
                                 init_state=torch.from_numpy(s0))
    assert y.shape == (2, S, 4, 8) and st.shape == (2, 4, 8, 16)
    yr, sr = t_ssd.ssd_scan_plain(*t, chunk=q,
                                  init_state=torch.from_numpy(s0),
                                  return_state=True)
    _close(y, yr)
    _close(st, sr)
    jy, js = jax_scan(x, dt, a, b, c, q, s0)
    _close(y, jy)
    _close(st, js)


def test_ops_ssd_state_is_forward_only():
    """``ops.ssd`` with a state returns (y with the D-skip, state); asked
    for a gradient it raises."""
    x, dt, a, b, c, s0 = _scan_inputs(8)
    t = [torch.from_numpy(v) for v in (x, dt, a, b, c)]
    d = torch.ones(4)
    y, st = ops.ssd(*t, chunk=4, d_skip=d, init_state=torch.from_numpy(s0),
                    return_state=True)
    jy, js = jax_scan(x, dt, a, b, c, 4, s0, np.ones(4, np.float32))
    _close(y, jy)
    _close(st, js)
    t[0].requires_grad_(True)
    with pytest.raises(NotImplementedError, match="no backward"):
        ops.ssd(*t, chunk=4, return_state=True)


# ------------------------------------------------------------- the mixer --

def _mixer(seed=0):
    jcfg, tcfg, _, _ = tw.model(ARCH)
    jp = jax_common.init_params(jax_mamba.mamba_specs(jcfg),
                                jax.random.PRNGKey(seed), jnp.float32)
    tp = ParamTree(jax.tree.map(lambda v: torch.tensor(np.asarray(v)), jp))
    return jcfg, tcfg, jp, tp


def _cache_pair(tcfg, B, seed):
    """The same random MambaCache in both packages."""
    rng = np.random.default_rng(seed)
    leaves = [rng.normal(size=x.shape).astype(np.float32) * 0.5
              for x in t_mamba.init_mamba_cache(tcfg, B, torch.float32)]
    return (jax_mamba.MambaCache(*map(jnp.asarray, leaves)),
            t_mamba.MambaCache(*(torch.from_numpy(v.copy())
                                 for v in leaves)))


def _assert_mamba(tc, jc, atol=tw.ATOL):
    for name, a, b in zip(jax_mamba.MambaCache._fields, tc, jc):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=atol,
                                   rtol=0, err_msg=name)


def test_mamba_prefill_chunks_match_jax():
    """Chunks of 6, 6 and 1 tokens, each continuing from the cache the
    last left, from a random cache: every chunk's output and the cache
    (conv tails, SSM state) within ATOL of ``mamba_prefill``'s; the port
    advances its cache in place."""
    jcfg, tcfg, jp, tp = _mixer()
    jc, tc = _cache_pair(tcfg, 2, 1)
    ptrs = [x.data_ptr() for x in tc]
    x = np.random.default_rng(2).normal(size=(2, 13, tcfg.d_model)).astype(
        np.float32)
    jstep = jax.jit(lambda p, x, c: jax_mamba.mamba_prefill(
        p, x, c, jcfg, precision="bf16"))
    s0 = 0
    for C in (6, 6, 1):
        xc = x[:, s0:s0 + C]
        jy, jc = jstep(jp, jnp.asarray(xc), jc)
        ty, tc = t_mamba.mamba_prefill(tp, torch.from_numpy(xc), tc, tcfg,
                                       precision="bf16")
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=tw.ATOL,
                                   rtol=0)
        _assert_mamba(tc, jc)
        s0 += C
    assert [x.data_ptr() for x in tc] == ptrs


def test_mamba_decode_active_mask_preserves_state():
    """Twin of tests/test_paged_kernel.py's case: an inactive row keeps its
    conv tails and SSM state bit for bit, an active row advances as the
    JAX package's ``mamba_decode`` does, in place."""
    jcfg, tcfg, jp, tp = _mixer()
    jc = jax_mamba.init_mamba_cache(jcfg, 2, jnp.float32)
    jc = jax_mamba.MambaCache(*(v + 0.5 for v in jc))
    tc = t_mamba.MambaCache(*(torch.from_numpy(np.array(v)) for v in jc))
    before = [v.clone() for v in tc]
    ptrs = [v.data_ptr() for v in tc]
    x = np.random.default_rng(3).normal(size=(2, 1, tcfg.d_model)).astype(
        np.float32)
    active = np.array([True, False])
    jy, jn = jax.jit(lambda p, x, c, act: jax_mamba.mamba_decode(
        p, x, c, jcfg, active=act))(jp, jnp.asarray(x), jc,
                                    jnp.asarray(active))
    ty, tn = t_mamba.mamba_decode(tp, torch.from_numpy(x), tc, tcfg,
                                  active=torch.from_numpy(active))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=tw.ATOL,
                               rtol=0)
    _assert_mamba(tn, jn)
    for old, new in zip(before, tn):
        assert torch.equal(new[1], old[1])            # frozen row
        assert not torch.equal(new[0], old[0])        # live row moved
    assert [v.data_ptr() for v in tn] == ptrs


# ------------------------------------------------------- serving families --

@pytest.mark.parametrize("rung,kind", tw.ENGINE_CASES,
                         ids=[f"{k}-rung{r}" for r, k in tw.ENGINE_CASES])
def test_engine_streams_match_jax_dense(rung, kind):
    tw.check_engine_case(ARCH, rung, kind)


def test_admission_matches_tokenwise_warmup():
    """The port's dense engine (prompts of 7 through chunks of 3, a ragged
    tail; 4 requests through 2 slots) gives the JAX package's
    token-by-token warmup streams."""
    _, tcfg, _, _ = tw.model(ARCH)
    prompts = tw.midrun(tcfg.vocab_size)[:4]
    got = tw.port_serve(tw.port_engine(ARCH), prompts, 5)
    assert got == [tw.warmup_ref(ARCH, p, 5) for p in prompts]


def test_snapshot_budget_bounds_prefix_snapshots():
    tw.check_snapshot_budget(ARCH)


def test_midrun_admission_interleaves_and_matches_dense():
    tw.check_midrun(ARCH)


def test_eos_mid_megastep_frees_slot_without_corrupting_siblings():
    tw.check_eos_megastep(ARCH)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_swap_across_kv_quant_mid_decode(paged):
    tw.check_swap(ARCH, paged)


def test_prefill_handoff_matches_jax():
    """``prefill_with_cache`` of 2 x 12 tokens: logits and the handed-off
    Mamba rows within ATOL of the JAX package's; decode continues from
    them as from the port's token-by-token warmup (the JAX test's 3e-3)."""
    from repro.serve import prefill as jax_prefill
    from repro_torch.serve import prefill as t_prefill
    jcfg, tcfg, jp, tp = tw.model(ARCH)
    toks = np.random.default_rng(1).integers(0, tcfg.vocab_size, (2, 12))
    jl, jc = jax.jit(lambda p, t: jax_prefill.prefill_with_cache(
        p, t, jcfg, 32))(jp, jnp.asarray(toks, jnp.int32))
    tl, tc = t_prefill.prefill_with_cache(tp, torch.from_numpy(toks), tcfg,
                                          32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tw.ATOL,
                               rtol=0)
    tw.assert_caches(tc, jc)
    wc = t_lm.init_caches(tcfg, 2, 32, dtype=torch.float32)
    for i in range(12):
        wl, wc = t_lm.decode_step(tp, torch.from_numpy(toks[:, i:i + 1]),
                                  torch.full((2,), i, dtype=torch.int32),
                                  wc, tcfg)
    np.testing.assert_allclose(tl.numpy(), wl.numpy(), rtol=3e-3, atol=3e-3)
    nxt = tl.argmax(-1)[:, None]
    pos = torch.full((2,), 12, dtype=torch.int32)
    a, _ = t_lm.decode_step(tp, nxt, pos, tc, tcfg)
    b, _ = t_lm.decode_step(tp, nxt, pos, wc, tcfg)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=3e-3, atol=3e-3)


def _mamba_fill(cfg, B, rng, paged):
    """Random leaves for ``init_caches`` / ``init_paged_caches`` Mamba rows
    in both packages."""
    shape = (t_lm.init_paged_caches(cfg, B, 8, 4, 2, dtype=torch.float32)
             if paged else t_lm.init_caches(cfg, B, 8, dtype=torch.float32))
    leaves = [[rng.normal(size=x.shape).astype(np.float32) for x in c]
              for c in shape]
    return (tuple(jax_mamba.MambaCache(*map(jnp.asarray, lv))
                  for lv in leaves),
            tuple(t_mamba.MambaCache(*(torch.from_numpy(v.copy())
                                       for v in lv)) for lv in leaves))


def test_insert_request_scatters_mamba_rows():
    """Row 1 of a 3-slot tree takes the one-request tree's rows as they
    are (JAX's ``insert_request``); rows 0 and 2 are unchanged."""
    _, tcfg, _, _ = tw.model(ARCH)
    rng = np.random.default_rng(4)
    jb, tb = _mamba_fill(tcfg, 3, rng, False)
    js, ts = _mamba_fill(tcfg, 1, rng, False)
    before = caches_to_numpy(tb)
    got = t_slots.insert_request(tb, ts, 1)
    tw.assert_caches(got, jax_slots.insert_request(jb, js, 1), atol=0)
    for b, g in zip(before, caches_to_numpy(got)):
        for x, y in zip(b, g):
            np.testing.assert_array_equal(x[:, [0, 2]], y[:, [0, 2]])


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_convert_roundtrip_carries_mamba_rows(paged):
    """Twin of tests/test_slots_convert.py on mamba2: every conversion of
    the chain fp32 -> int8 -> fp32 -> int8 leaves the Mamba rows
    bit-identical (the same tensors), as JAX's does."""
    _, tcfg, _, _ = tw.model(ARCH)
    j0, t0 = _mamba_fill(tcfg, 2, np.random.default_rng(0), paged)
    jchain, tchain = j0, t0
    for q in (True, False, True):
        jchain = jax_slots.convert_caches(jchain, q)
        tchain = t_slots.convert_caches(tchain, q)
        tw.assert_caches(tchain, jchain, atol=0)
        assert all(a is b for a, b in zip(tchain, t0))


def test_forward_and_train_step():
    """Twin of tests/test_models_smoke.py's mamba2 case: one training step
    of the port (2 x 32 tokens, no remat) from the JAX package's weights:
    its loss within 1e-5 of the JAX package's ``lm_loss``, finite and
    positive gradient norm, every parameter moved, shapes kept."""
    import copy

    from repro.models import lm as jax_lm
    from repro_torch.train import optim
    from repro_torch.train.step import make_train_step
    jcfg, tcfg, jp, tp = tw.model(ARCH)
    tp = copy.deepcopy(tp)
    toks = np.random.default_rng(1).integers(0, tcfg.vocab_size, (2, 33))
    jloss, _ = jax.jit(lambda p, t: jax_lm.lm_loss(
        p, {"tokens": t}, jcfg, remat="none"))(jp, jnp.asarray(toks))
    before = {k: v.clone() for k, v in tp.named_parameters()}
    step = make_train_step(tcfg, opt_cfg=optim.OptConfig(
        lr=1e-3, warmup=2, total_steps=10), remat="none")
    tp, opt, m = step(tp, optim.init_opt(tp),
                      {"tokens": torch.from_numpy(toks)})
    assert abs(float(m["loss"]) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert np.isfinite(float(m["grad_norm"])) and float(m["grad_norm"]) > 0
    moved = 0.0
    for k, v in tp.named_parameters():
        assert v.shape == before[k].shape and v.dtype == before[k].dtype
        moved += float((v - before[k]).abs().sum().detach())
    assert moved > 0 and int(opt.step) == 1
