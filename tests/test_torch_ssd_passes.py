"""The chunk-parallel passes of the port's ``ssd_scan`` kernels, in plain
PyTorch, against the JAX package on the CPU: the forward as its four passes
(``ssd_passes_plain``) against ``ssd_scan_plain`` and the Pallas kernel in
interpret mode, the closed chunked backward (``ssd_scan_backward_plain``,
what the backward kernels compute and what ``SSDScan`` runs on a CPU
tensor) against ``jax.grad`` of ``ssd_chunked_ref``, also where the JAX
twin's own gradient overflows, and an fp64 gradient check. Inputs are drawn
with numpy and handed to both packages. JAX is imported inside the tests
that use it, so that the file also runs on the card, where the one test
marked ``cuda`` holds the kernels to the plain versions.

Tolerances as ``tests/test_torch_ssd.py``: fp32 outputs within 1e-5 of
their largest magnitude (sums in other orders), gradients within 1e-4 of
their largest entry (the gradient of ``a`` sums ~1e4 terms)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ssd_scan as tss

FP32_REL = 1e-5
GRAD_REL = 1e-4


def _case(B, S, H, P, N, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(B, S, H, P)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(B, S, H)))).astype(np.float32)
    a = (-np.exp(rng.uniform(size=(H,)))).astype(np.float32)
    b = (rng.normal(size=(B, S, N)) * 0.5).astype(np.float32)
    c = (rng.normal(size=(B, S, N)) * 0.5).astype(np.float32)
    return x, dt, a, b, c


def _close(got, want, rel):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


def _jax_grads(ins, gy, chunk, fn="ssd_chunked_ref"):
    import jax
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    f = getattr(jref, fn)
    kw = {"chunk": chunk} if fn == "ssd_chunked_ref" else {}

    def loss(*args):
        return jnp.sum(f(*args, **kw) * gy)
    return jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))(
        *map(jnp.asarray, ins))


# (B, S, H, P, N), Q: one chunk and several, Q 16 and 32, P below the
# kernels' 64-column tile and above it but not a multiple of it
PASS_CASES = [((1, 16, 2, 20, 8), 16), ((2, 64, 3, 20, 12), 16),
              ((1, 32, 2, 72, 16), 32), ((2, 128, 2, 72, 8), 32)]


@pytest.mark.parametrize("shape,chunk", PASS_CASES)
def test_passes_match_plain_and_pallas_interpret(shape, chunk):
    """Passes 1-4 (cum and G once for every head, the chunks' local states
    in parallel, the state passing, y) give ``ssd_scan_plain``'s y and the
    Pallas kernel's."""
    import jax.numpy as jnp
    from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan
    ins = _case(*shape, seed=1)
    want = jax_ssd_scan(*map(jnp.asarray, ins), chunk=chunk, interpret=True)
    got = tss.ssd_passes_plain(*map(torch.tensor, ins), chunk=chunk)
    assert got.dtype == torch.float32 and got.shape == shape[:3] + shape[3:4]
    _close(got.numpy(), want, FP32_REL)
    _close(got.numpy(), tss.ssd_scan_plain(*map(torch.tensor, ins),
                                           chunk=chunk).numpy(), FP32_REL)


def test_state_pass_forward_and_reverse():
    """Pass 3 and its reverse: the state entering each chunk, and the
    cotangent leaving it, against the recurrences written out chunk by
    chunk (the first chunk enters at zero, the last leaves at zero)."""
    rng = np.random.default_rng(2)
    loc = torch.tensor(rng.normal(size=(2, 5, 3, 4, 6)))
    total = torch.tensor(-rng.uniform(0, 3, size=(2, 5, 3)))
    fwd = tss._state_pass(loc, total, reverse=False)
    rev = tss._state_pass(loc, total, reverse=True)
    d = torch.exp(total)[..., None, None]
    run = torch.zeros_like(loc[:, 0])
    for c in range(5):
        torch.testing.assert_close(fwd[:, c], run)
        run = d[:, c] * run + loc[:, c]
    run = torch.zeros_like(loc[:, 0])
    for c in reversed(range(5)):
        torch.testing.assert_close(rev[:, c], run)
        run = d[:, c] * run + loc[:, c]


@pytest.mark.parametrize("shape,chunk", [((1, 16, 2, 8, 4), 16),
                                         ((2, 64, 3, 16, 8), 16),
                                         ((1, 128, 2, 20, 12), 32)])
def test_backward_plain_matches_jax_grad(shape, chunk):
    """The closed form's five gradients against ``jax.grad`` of the JAX
    ``ssd_chunked_ref`` (the function the JAX package differentiates on
    the CPU), one chunk and several."""
    ins = _case(*shape, seed=3)
    gy = np.random.default_rng(4).normal(size=shape[:4]).astype(np.float32)
    want = _jax_grads(ins, gy, chunk)
    got = tss.ssd_scan_backward_plain(*map(torch.tensor, ins),
                                      torch.tensor(gy), chunk=chunk)
    for name, t, g, w in zip("x dt a b c".split(), ins, got, want):
        assert g.shape == t.shape and g.dtype == torch.float32, name
        _close(g.numpy(), w, GRAD_REL)


def test_backward_plain_where_the_jax_twin_overflows():
    """The strong decay of ``test_chunked_grads_finite_where_the_jax_twin_
    overflows`` (dt·a = -24 a token: cum_t - cum_i > 88 above the
    diagonal, where ``jax.grad`` of the JAX twin is NaN) through the closed
    form: finite, and equal to ``jax.grad`` of the per-token recurrence
    ``ssd_ref``, which takes no exp of a positive number."""
    x, _, _, b, c = _case(1, 16, 2, 4, 4, seed=12)
    dt = np.full((1, 16, 2), 1.5, np.float32)
    a = np.array([-16.0, -1.0], np.float32)
    gy = np.random.default_rng(13).normal(size=x.shape).astype(np.float32)
    ins = (x, dt, a, b, c)
    assert any(np.isnan(np.asarray(g)).any()
               for g in _jax_grads(ins, gy, 8))
    want = _jax_grads(ins, gy, 8, fn="ssd_ref")
    got = tss.ssd_scan_backward_plain(*map(torch.tensor, ins),
                                      torch.tensor(gy), chunk=8)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        _close(g.numpy(), w, GRAD_REL)


@pytest.mark.parametrize("S,chunk", [(8, 4), (8, 8), (12, 4)])
def test_ssd_function_gradcheck_fp64_closed_form(S, chunk):
    """``SSDScan``'s backward on a CPU tensor is the closed form: finite
    differences in fp64 through the Function, one chunk and several."""
    rng = np.random.default_rng(9 + S + chunk)
    B, H, P, N = 1, 2, 3, 2
    x = rng.normal(size=(B, S, H, P))
    dt = np.log1p(np.exp(rng.normal(size=(B, S, H))))
    a = -np.exp(rng.uniform(size=(H,)))
    b, c = rng.normal(size=(B, S, N)), rng.normal(size=(B, S, N))
    ins = tuple(torch.tensor(t, dtype=torch.float64, requires_grad=True)
                for t in (x, dt, a, b, c))
    y = tss.SSDScan.apply(*ins, chunk)
    g = torch.autograd.grad(y, ins, torch.ones_like(y))
    want = tss.ssd_scan_backward_plain(*(t.detach() for t in ins),
                                       torch.ones_like(y), chunk=chunk)
    for u, v in zip(g, want):
        torch.testing.assert_close(u, v, rtol=0, atol=0)
    assert torch.autograd.gradcheck(lambda *t: tss.SSDScan.apply(*t, chunk),
                                    ins, eps=1e-6, atol=1e-7, rtol=1e-6)


def test_backward_plain_bf16_dtypes():
    """bf16 x, b, c: the closed form computes in fp32 from the exact
    upcasts and returns x's, b's and c's gradients in bf16, dt's and a's
    in fp32, each within one bf16 step of the fp32 inputs' gradients."""
    ins = _case(2, 32, 2, 8, 8, seed=5)
    gy = torch.tensor(np.random.default_rng(6).normal(size=(2, 32, 2, 8)),
                      dtype=torch.float32).to(torch.bfloat16)
    x, dt, a, b, c = map(torch.tensor, ins)
    xb, bb, cb = (t.to(torch.bfloat16) for t in (x, b, c))
    got = tss.ssd_scan_backward_plain(xb, dt, a, bb, cb, gy, chunk=16)
    want = tss.ssd_scan_backward_plain(xb.float(), dt, a, bb.float(),
                                       cb.float(), gy.float(), chunk=16)
    assert [g.dtype for g in got] == [torch.bfloat16, torch.float32,
                                      torch.float32, torch.bfloat16,
                                      torch.bfloat16]
    for g, w in zip(got, want):
        _close(g.float().numpy(), w.numpy(), 2.0 ** -7)


@pytest.mark.parametrize("B,nc,H,Q,N", [(4, 8, 48, 128, 128),
                                        (3, 8, 48, 128, 128),
                                        (2, 2, 8, 16, 16), (1, 1, 5, 64, 72)])
def test_splits_cover_every_head_once(B, nc, H, Q, N):
    """The backward's head groups (dG pass) and splits (dB/dC pass), from
    shapes alone: consecutive ranges that cover every head exactly once,
    none empty."""
    hpg, ng, hps, ns = tss.splits(B, nc, H, Q, N)
    for per, n in ((hpg, ng), (hps, ns)):
        ranges = [range(k * per, min(H, (k + 1) * per)) for k in range(n)]
        assert all(len(r) for r in ranges)
        assert [h for r in ranges for h in r] == list(range(H))


def test_backward_rejects_what_the_kernels_do_not_take():
    """A non-CPU, non-CUDA tensor raises; it never falls back."""
    x, dt, a, b, c = (torch.tensor(t) for t in _case(1, 16, 1, 4, 4))
    from _torch_elsewhere import elsewhere
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tss._launch_backward(elsewhere(x), dt, a, b, c, elsewhere(x), 16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernels_match_plain_on_the_card(dtype):
    """On the card: the forward passes and the backward passes against the
    plain versions at a small shape with P and N off the tiles, their
    launches counted as ``FWD_PASSES`` and ``BWD_PASSES``, and the
    backward's gradients the same bits from run to run (no atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels are CUDA C++, built "
                    "with nvcc")
    dev, dt_ = torch.device("cuda"), getattr(torch, dtype)
    x, dt, a, b, c = (torch.tensor(t, device=dev)
                      for t in _case(2, 96, 3, 72, 20, seed=7))
    x, b, c = (t.to(dt_) for t in (x, b, c))
    gy = torch.randn(x.shape, device=dev).to(dt_)
    f0, b0 = tss.launches, tss.backward_launches
    y = tss.ssd_scan(x, dt, a, b, c, chunk=32)
    got = tss.ssd_scan_backward(x, dt, a, b, c, gy, chunk=32)
    again = tss.ssd_scan_backward(x, dt, a, b, c, gy, chunk=32)
    assert tss.launches - f0 == tss.FWD_PASSES
    assert tss.backward_launches - b0 == 2 * tss.BWD_PASSES
    want = tss.ssd_scan_plain(x, dt, a, b, c, chunk=32)
    rel = FP32_REL if dtype == "float32" else 2.0 ** -7
    _close(y.float().cpu(), want.float().cpu(), rel)
    ref = tss.ssd_scan_backward_plain(x, dt, a, b, c, gy, chunk=32)
    for name, g, w, g2 in zip("x dt a b c".split(), got, ref, again):
        assert torch.equal(g, g2), name
        tol = 2.0 ** -7 if dtype == "bfloat16" and name in "xbc" else 1e-3
        _close(g.float().cpu(), w.float().cpu(), tol)
