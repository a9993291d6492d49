"""The port's kernel modules against the JAX package, on the CPU.

The CUDA kernels cannot run here; their plain PyTorch versions (what the
wrappers run for a CPU tensor, and what the card's kernels are held to) are
compared with the Pallas kernels in interpret mode and with the JAX
references, on the same numpy-seeded inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import int8_matmul as jax_i8
from repro.kernels import paged_attention as jax_pa
from repro.kernels import ref as jax_ref
from repro.models import attention as jax_attn
from repro_torch.kernels import _build
from repro_torch.kernels import int8_matmul as t_i8
from repro_torch.kernels import paged_attention as t_pa
from repro_torch.kernels import ref as t_ref
from repro_torch.models import attention as t_attn

P, M = 4, 6                    # page size, block-table width


def _paged_inputs(lengths, *, G, R, hd, quantized, seed=0, extra=()):
    """Slots holding ``lengths[b]`` resident tokens (ragged page counts,
    partial last pages; the decode entry at position ``lengths[b]`` already
    written), one speculative future page per slot filled with large
    values, and ``extra`` slots (position, mapped pages with empty ppos)
    whose running pages hold no valid entry."""
    rng = np.random.default_rng(seed)
    B = len(lengths) + len(extra)
    n_pages = 1 + B * M
    kp = rng.normal(size=(n_pages, P, G, hd)) * 0.3
    vp = rng.normal(size=(n_pages, P, G, hd))
    block = np.zeros((B, M), np.int32)
    ppos = np.full((n_pages, P), -1, np.int32)
    pid = 1
    for b, L in enumerate(lengths):
        live = -(-(L + 1) // P)
        for lp in range(min(live + 1, M)):
            block[b, lp] = pid
            if lp < live:
                top = min(L + 1, (lp + 1) * P)
                ppos[pid, :top - lp * P] = np.arange(lp * P, top)
            else:
                kp[pid], vp[pid] = 1e3, -1e3
            pid += 1
    position = list(lengths)
    for b, (pos, n_mapped) in enumerate(extra, start=len(lengths)):
        block[b, :n_mapped] = np.arange(pid, pid + n_mapped)
        pid += n_mapped
        position.append(pos)
    if quantized:
        kp = np.clip(np.round(kp / t_attn.KV_SCALE), -127, 127).astype(np.int8)
        vp = np.clip(np.round(vp / t_attn.KV_SCALE), -127, 127).astype(np.int8)
    else:
        kp, vp = kp.astype(np.float32), vp.astype(np.float32)
    q = rng.normal(size=(B, G, R, hd)).astype(np.float32)
    return q, kp, vp, ppos, block, np.asarray(position, np.int32)


def _both(arrs):
    return [jnp.asarray(a) for a in arrs], [torch.from_numpy(a) for a in arrs]


# (G, R, hd, cap): phi4-mini smoke GQA widths; softcap with GQA (gemma2)
@pytest.mark.parametrize("G,R,hd,cap", [(2, 2, 16, 0.0), (2, 2, 16, 50.0),
                                        (1, 4, 32, 0.0)])
@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("quantized", [False, True])
def test_paged_plain_matches_pallas_interpret(G, R, hd, cap, window,
                                              quantized):
    """All rows, inactive ones included: an unmapped slot (zeros) and a slot
    whose running pages hold only empty entries. fp32 throughout; the two
    sum in other orders (atol 1e-5)."""
    arrs = _paged_inputs([0, 5, 9, 14, 20], G=G, R=R, hd=hd,
                         quantized=quantized, extra=[(7, 0), (6, 2)])
    j, t = _both(arrs)
    kv_scale = t_attn.KV_SCALE if quantized else 0.0
    want = jax_pa.paged_attention(*j, window=window, kv_scale=kv_scale,
                                  cap=cap, interpret=True)
    got = t_pa.paged_attention_plain(*t, window=window, kv_scale=kv_scale,
                                     cap=cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("window", [0, 8])
def test_paged_plain_matches_gather_reference(quantized, window):
    """Active rows against the JAX gather path (``_gather_pages`` +
    ``_sdpa``) that the JAX engine decodes with on the CPU (atol 1e-5)."""
    lengths = [0, 5, 9, 14, 20]
    G, R, hd = 2, 2, 16
    q, kp, vp, ppos, block, pos = _paged_inputs(lengths, G=G, R=R, hd=hd,
                                                quantized=quantized)
    kv_scale = t_attn.KV_SCALE if quantized else 0.0
    cache = jax_attn.PagedKVCache(jnp.asarray(kp), jnp.asarray(vp),
                                  jnp.asarray(ppos), jnp.asarray(block))
    kk, vv, _, valid = jax_attn._gather_pages(
        cache, cache.block, jnp.asarray(pos)[:, None], window=window)
    dq = (lambda a: jax_attn.dequantize_kv(a, jnp.float32, kv_scale)) \
        if quantized else (lambda a: a)
    B = len(lengths)
    want = jax_attn._sdpa(jnp.asarray(q).reshape(B, 1, G, R, hd), dq(kk),
                          dq(vv), mask=valid[:, None, None])[:, 0]
    got = t_pa.paged_attention_plain(
        *(torch.from_numpy(a) for a in (q, kp, vp, ppos, block, pos)),
        window=window, kv_scale=kv_scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_quantize_rowwise_exact():
    """int8 values equal exactly, scales bit-equal: both divide in fp32 and
    round half to even (the second row puts entries exactly on .5)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(6, 40)).astype(np.float32)
    x[1, :5] = [127.0, 0.5, 1.5, 2.5, -3.5]
    for axis in (-1, 0):
        jq, js = jax_ref.quantize_rowwise(jnp.asarray(x), axis=axis)
        tq, ts = t_ref.quantize_rowwise(torch.from_numpy(x), axis=axis)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    tq, _ = t_ref.quantize_rowwise(torch.from_numpy(x[1:2, :5]))
    assert tq.tolist() == [[127, 0, 2, 2, -4]]


def _int8_operands(M, K, N, seed=0):
    rng = np.random.default_rng(seed)
    x_q = rng.integers(-127, 128, (M, K), dtype=np.int8)
    w_q = rng.integers(-127, 128, (K, N), dtype=np.int8)
    xs = (rng.random((M, 1)) * 1e-2 + 1e-4).astype(np.float32)
    ws = (rng.random((1, N)) * 1e-2 + 1e-4).astype(np.float32)
    return x_q, xs, w_q, ws


def test_int8_plain_matches_pallas_interpret():
    """Exact: int32 sums stay below 2^24 here, where the Pallas kernel's
    fp32 block sums are exact too."""
    arrs = _int8_operands(8, 256, 128)
    want = jax_i8.int8_matmul(*map(jnp.asarray, arrs), bk=128,
                              out_dtype=jnp.float32, interpret=True)
    got = t_i8.int8_matmul_plain(*map(torch.from_numpy, arrs),
                                 out_dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("M,K,N", [(5, 30, 7), (1, 3072, 64), (3, 64, 8)])
def test_int8_plain_matches_ref_ragged(M, K, N):
    """Ragged M (decode batch), K and N, which the Pallas kernel asserts
    away: exact against ``int8_matmul_ref``, bf16 and fp32 outputs."""
    arrs = _int8_operands(M, K, N, seed=M)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        want = jax_ref.int8_matmul_ref(*map(jnp.asarray, arrs),
                                       out_dtype=jdt)
        got = t_i8.int8_matmul(*map(torch.from_numpy, arrs), out_dtype=tdt)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want).astype(np.float32))


def test_quantized_matmul_matches_ref():
    """End to end W8A8 (quantize both sides, int8 product, scales): exact."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 3, 64)).astype(np.float32)
    w = (rng.normal(size=(64, 48)) / 8).astype(np.float32)
    want = jax_ref.quantized_matmul_ref(jnp.asarray(x), jnp.asarray(w))
    from repro_torch.kernels import ops
    got = ops.quantized_matmul(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_wrappers_raise_instead_of_falling_back():
    """A tensor that is not on the CPU goes to the kernel or raises: here a
    tensor on another device than the CPU, CUDA or ``meta`` (the dry-run's
    trace, which takes the card's path up to the launch) is refused, and
    without CUDA loading the kernels raises rather than handing the call
    to the plain version."""
    from _torch_elsewhere import elsewhere
    if torch.cuda.is_available():
        pytest.skip("a CUDA machine builds the kernels instead")
    meta = lambda *s, dt=torch.float32: elsewhere(torch.empty(s, dtype=dt))
    with pytest.raises(ValueError):
        t_i8.int8_matmul(meta(2, 4, dt=torch.int8), meta(2, 1),
                         meta(4, 3, dt=torch.int8), meta(1, 3))
    with pytest.raises(ValueError):
        t_pa.paged_attention(meta(1, 1, 2, 8), meta(2, 4, 1, 8),
                             meta(2, 4, 1, 8), meta(2, 4, dt=torch.int32),
                             meta(1, 2, dt=torch.int32),
                             meta(1, dt=torch.int32))
    for name in _build.SOURCES:
        with pytest.raises(RuntimeError, match="CUDA"):
            _build.load(name, [])
    assert t_i8.launches == 0 and t_pa.launches == 0


def test_cost_model_matches_jax():
    for kw in (dict(kv_bytes=2, batch=8, n_heads=24, q_bytes=2,
                    max_pages=64), dict(kv_bytes=1)):
        assert t_pa.decode_hbm_bytes(118, 16, 8, 128, **kw) == \
            jax_pa.decode_hbm_bytes(118, 16, 8, 128, **kw)
