"""The port's ``flash_attention`` (its plain version, which CPU tensors take)
and ``mha_ref`` twin against the JAX package, on the CPU: the same numpy
inputs through the Pallas kernel in interpret mode (``bq = bk = 64``) or
``repro.kernels.ref.mha_ref`` and through the port.

Tolerances: fp32 outputs within 1e-5 absolute (|out| <= ~4 here; the Pallas
body's online softmax and the plain version's one-pass softmax sum in other
orders, measured <= 2.4e-7); bf16 outputs within one bf16 step (2^-8
relative) of the largest |out|, since ``p`` is rounded to bf16 against a
running max in the kernel and the final max in the plain version;
gradients within 1e-5 of each gradient's largest entry."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ref

ATOL = 1e-5
GRAD_REL = 1e-5
MASKS = [dict(causal=True), dict(causal=False),
         dict(causal=True, window=64), dict(causal=True, cap=30.0),
         dict(causal=True, window=128, cap=50.0)]
MASK_IDS = ["causal", "full", "window64", "cap30", "window128+cap50"]


def _qkv(B, H, KVH, Sq, Skv, hd, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, Sq, hd)) * 0.3
    k = rng.normal(size=(B, KVH, Skv, hd)) * 0.3
    v = rng.normal(size=(B, KVH, Skv, hd))
    return [a.astype(dtype) for a in (q, k, v)]


def _pallas(q, k, v, **kw):
    return np.asarray(jax_flash(*(jnp.asarray(a) for a in (q, k, v)),
                                interpret=True, bq=64, bk=64, **kw),
                      np.float32)


def _plain(q, k, v, **kw):
    return fa.flash_attention(*(torch.tensor(a) for a in (q, k, v)),
                              bq=64, bk=64, **kw).float().numpy()


@pytest.mark.parametrize("kvh", [8, 2, 1])
@pytest.mark.parametrize("kw", MASKS, ids=MASK_IDS)
def test_flash_plain_matches_pallas_interpret(kvh, kw):
    """The cases of the JAX package's kernel test: B 2, H 8, S 256, hd 64."""
    q, k, v = _qkv(2, 8, kvh, 256, 256, 64)
    np.testing.assert_allclose(_plain(q, k, v, **kw), _pallas(q, k, v, **kw),
                               rtol=0, atol=ATOL)


def test_flash_plain_bf16_matches_pallas_interpret():
    q, k, v = (jnp.asarray(a, jnp.bfloat16) for a in _qkv(1, 4, 4, 128, 128,
                                                          64))
    want = np.asarray(jax_flash(q, k, v, interpret=True, bq=64, bk=64),
                      np.float32)
    tq, tk, tv = (torch.tensor(np.asarray(a, np.float32)).to(torch.bfloat16)
                  for a in (q, k, v))
    got = fa.flash_attention(tq, tk, tv, bq=64, bk=64)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2.0 ** -8 * np.abs(want).max())


def test_flash_plain_kv_perforation_matches_pallas_interpret():
    """``kv_keep_stride`` 4 drops off-diagonal blocks by the kernel's
    relative rule: equal to the Pallas kernel, different from precise
    attention, identical to it on the first two query blocks."""
    q, k, v = _qkv(1, 2, 2, 512, 512, 32)
    got = _plain(q, k, v, kv_keep_stride=4)
    np.testing.assert_allclose(got, _pallas(q, k, v, kv_keep_stride=4),
                               rtol=0, atol=ATOL)
    precise = _plain(q, k, v)
    assert np.abs(got - precise).max() > 1e-3
    np.testing.assert_allclose(got[:, :, :128], precise[:, :, :128],
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("sq,skv,kw", [
    (100, 100, dict(causal=False)), (130, 130, dict(causal=False)),
    (37, 64, dict(causal=False)), (100, 100, dict(causal=True, window=16))])
def test_flash_plain_ragged_tail(sq, skv, kw):
    """Lengths off the block grid: the KV tail padded and masked, padded
    query rows dropped (the JAX package's ragged-tail cases, GQA 4/2)."""
    q, k, v = _qkv(1, 4, 2, sq, skv, 32, seed=sq)
    got = _plain(q, k, v, **kw)
    assert got.shape == (1, 4, sq, 32)
    np.testing.assert_allclose(got, _pallas(q, k, v, **kw), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("sq,skv,kw", [
    (64, 200, dict(causal=True)),
    (200, 64, dict(causal=True, window=16)),
    (150, 90, dict(causal=True, kv_keep_stride=2))])
def test_flash_plain_start_aligned(sq, skv, kw):
    """Sq != Skv: query row r sits at position r. Rows 80..127 of the
    (200, 64) case see only masked entries of a running block (the mean of
    V over it), rows 128.. no running block (zeros), as in the Pallas body;
    ``mha_ref`` aligns the ends instead and gives other rows."""
    q, k, v = _qkv(1, 4, 2, sq, skv, 32, seed=sq + skv)
    got = _plain(q, k, v, **kw)
    np.testing.assert_allclose(got, _pallas(q, k, v, **kw), rtol=0,
                               atol=ATOL)
    end = ref.mha_ref(*(torch.tensor(a) for a in (q, k, v)),
                      causal=True, window=kw.get("window", 0)).numpy()
    assert np.abs(got - end).max() > 1e-2
    if sq == 200:
        mean_v = v[:, :, None].mean(axis=3)                 # (1,2,1,32)
        np.testing.assert_allclose(
            got[:, :, 80:128], np.repeat(np.repeat(mean_v, 2, 1), 48, 2),
            rtol=0, atol=1e-6)
        assert not got[:, :, 128:].any()


@pytest.mark.parametrize("kw", [
    dict(causal=True), dict(causal=False), dict(causal=True, window=8),
    dict(causal=True, window=8, cap=5.0), dict(causal=True, cap=30.0)],
    ids=["causal", "full", "window8", "window8+cap5", "cap30"])
@pytest.mark.parametrize("sq,skv", [(16, 16), (5, 16)])
def test_mha_ref_matches_jax(kw, sq, skv):
    """The twin keeps the end alignment (decode, Sq < Skv) and GQA."""
    q, k, v = _qkv(2, 4, 2, sq, skv, 16, seed=3)
    want = np.asarray(jax_ref.mha_ref(*(jnp.asarray(a) for a in (q, k, v)),
                                      **kw))
    got = ref.mha_ref(*(torch.tensor(a) for a in (q, k, v)), **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_mha_ref_bf16_matches_jax():
    q, k, v = _qkv(1, 4, 1, 32, 32, 16, seed=4)
    want = np.asarray(jax_ref.mha_ref(*(jnp.asarray(a, jnp.bfloat16)
                                        for a in (q, k, v))), np.float32)
    got = ref.mha_ref(*(torch.tensor(a).to(torch.bfloat16)
                        for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2.0 ** -8 * np.abs(want).max())


def _close_rel(got, want, rel, what):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=rel * np.abs(want).max(), err_msg=what)


@pytest.mark.parametrize("kw", [
    dict(causal=True), dict(causal=False), dict(causal=True, window=24),
    dict(causal=True, cap=20.0)], ids=["causal", "full", "window24",
                                       "cap20"])
def test_flash_attention_grads_match_jax_grad_of_mha_ref(kw):
    """``FlashAttention``'s backward (the VJP of the plain version) against
    ``jax.grad`` of ``mha_ref``: at Sq == Skv and stride 1 the two compute
    the same function. The JAX package has no gradient through the Pallas
    kernel itself."""
    q, k, v = _qkv(2, 4, 2, 96, 96, 32, seed=5)
    g = np.random.default_rng(6).normal(size=q.shape).astype(np.float32)
    jg = jax.grad(lambda a, b, c: jnp.sum(jax_ref.mha_ref(a, b, c, **kw) * g),
                  argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = fa.FlashAttention.apply(*ts, kw.get("causal", True),
                                  kw.get("window", 0), kw.get("cap", 0.0), 1)
    tg = torch.autograd.grad((out * torch.tensor(g)).sum(), ts)
    for name, got, want in zip("qkv", tg, jg):
        _close_rel(got.numpy(), want, GRAD_REL, name)


def test_flash_backward_row_blocks_equal_one_pass():
    """The backward recomputes ~1024 query rows at a time; over 1100 rows
    (two blocks), with perforation and a window, its gradients equal
    autograd through the whole plain version at once (fp64)."""
    q, k, v = (torch.tensor(a, dtype=torch.float64)
               for a in _qkv(1, 2, 1, 1100, 1100, 16, seed=7))
    g = torch.tensor(np.random.default_rng(8).normal(size=q.shape))
    kw = dict(causal=True, window=700, cap=0.0, kv_keep_stride=2)
    ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
    kp, vp = fa._pad_kv(ts[1], ts[2], 128)
    whole = fa._plain_rows(ts[0], kp, vp, 0, bq=128, bk=128, n_kv=1100, **kw)
    want = torch.autograd.grad((whole * g).sum(), ts)
    got = fa.flash_attention_backward(q, k, v, g, **kw)
    for name, a, b in zip("qkv", got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-12, msg=name)


def test_jax_ops_flash_on_cpu_drops_the_stride_and_aligns_ends():
    """Reference fault (ROADMAP queue 3): off the TPU, JAX ``ops.flash``
    calls ``mha_ref``, so ``kv_keep_stride`` is dropped and positions are
    end-aligned, while the Pallas kernel perforates and aligns starts. The
    port's ``ops.flash`` follows the kernel on both devices."""
    q, k, v = _qkv(1, 2, 2, 512, 512, 32, seed=9)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    tq, tk, tv = (torch.tensor(a) for a in (q, k, v))
    cpu_ops = np.asarray(jax_ops.flash(jq, jk, jv, kv_keep_stride=4))
    precise = np.asarray(jax_ref.mha_ref(jq, jk, jv))
    kernel = np.asarray(jax_flash(jq, jk, jv, kv_keep_stride=4,
                                  interpret=True))
    np.testing.assert_array_equal(cpu_ops, precise)
    assert np.abs(kernel - precise).max() > 1e-2
    port = ops.flash(tq, tk, tv, kv_keep_stride=4).numpy()
    np.testing.assert_allclose(port, kernel, rtol=0, atol=ATOL)
    # Sq != Skv: JAX ops.flash end-aligns, the kernel and the port start-align
    q2 = q[:, :, :100]
    jq2, tq2 = jnp.asarray(q2), torch.tensor(q2)
    cpu_ops2 = np.asarray(jax_ops.flash(jq2, jk, jv))
    kernel2 = np.asarray(jax_flash(jq2, jk, jv, interpret=True))
    port2 = ops.flash(tq2, tk, tv).numpy()
    assert np.abs(cpu_ops2 - kernel2).max() > 1e-2
    np.testing.assert_allclose(port2, kernel2, rtol=0, atol=ATOL)


def test_flash_wrapper_dispatch():
    """A CPU tensor takes the plain version (no launch counted); any other
    device than CPU or CUDA raises instead of falling back."""
    q, k, v = (torch.tensor(a) for a in _qkv(1, 2, 1, 16, 16, 16))
    fa.launches = 0
    out = fa.flash_attention(q, k, v)
    torch.testing.assert_close(out, fa.flash_attention_plain(q, k, v),
                               rtol=0, atol=0)
    assert fa.launches == 0
    from _torch_elsewhere import elsewhere
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fa.flash_attention(elsewhere(q), elsewhere(k), elsewhere(v))
