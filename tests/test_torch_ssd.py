"""The port's Mamba2 SSD against the JAX package on the CPU: the plain
version of the ``ssd_scan`` kernel against the Pallas kernel in interpret
mode, the ``ssd_ref`` / ``ssd_chunked_ref`` twins against their JAX
originals, and the ``SSDScan`` autograd Function's gradients against
``jax.grad`` of ``ssd_chunked_ref`` (the function the JAX package
differentiates on the CPU). Inputs are drawn with numpy and handed to both.

Tolerances: fp32 sums taken in other orders (cumsum, the chunk products and
the exp of differences of cumulative sums) agree to ~1e-6 of the largest
output (measured: 2.2e-5 at |y| <= 21), so fp32 outputs are held to 1e-5
of their largest magnitude; bf16 outputs to one bf16 step (2^-8) of it.
Gradients sum over more terms (the gradient of ``a`` over every token, head
channel and chunk pair, ~1e4 terms here) and are held to 1e-4 of their
largest entry (measured: 1.4e-5)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as tss

FP32_REL = 1e-5
BF16_REL = 2.0 ** -8
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


# the shapes of tests/test_kernels.py::test_ssd_scan_matches_naive
SHAPES = [(1, 64, 2, 16, 8), (2, 128, 3, 32, 16), (1, 256, 4, 64, 32)]


@pytest.mark.parametrize("shape", SHAPES)
def test_ssd_scan_plain_matches_pallas_interpret(shape):
    ins = _case(*shape)
    chunk = min(32, shape[1])
    want = jax_ssd_scan(*map(jnp.asarray, ins), chunk=chunk, interpret=True)
    got = tss.ssd_scan_plain(*map(torch.tensor, ins), chunk=chunk)
    _close(got.numpy(), want, FP32_REL)
    # on a CPU tensor the kernel's wrapper is its plain version
    assert torch.equal(tss.ssd_scan(*map(torch.tensor, ins), chunk=chunk),
                       got)


def test_ssd_scan_plain_bf16_matches_pallas_interpret():
    """bf16 x, b, c: both upcast exactly, compute in fp32, round y once."""
    x, dt, a, b, c = _case(2, 128, 3, 32, 16, seed=1)
    xj, bj, cj = (jnp.asarray(t, jnp.bfloat16) for t in (x, b, c))
    want = jax_ssd_scan(xj, jnp.asarray(dt), jnp.asarray(a), bj, cj,
                        chunk=32, interpret=True)
    xt, bt, ct = (torch.tensor(t).to(torch.bfloat16) for t in (x, b, c))
    got = tss.ssd_scan_plain(xt, torch.tensor(dt), torch.tensor(a), bt, ct,
                             chunk=32)
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), np.asarray(want, np.float32), BF16_REL)


@pytest.mark.parametrize("d_skip", [False, True])
def test_ssd_ref_twin(d_skip):
    x, dt, a, b, c = _case(1, 48, 2, 8, 4, seed=2)
    d = np.linspace(0.5, 1.5, 2).astype(np.float32) if d_skip else None
    want = jref.ssd_ref(*map(jnp.asarray, (x, dt, a, b, c)),
                        d_skip=None if d is None else jnp.asarray(d))
    got = tref.ssd_ref(*map(torch.tensor, (x, dt, a, b, c)),
                       d_skip=None if d is None else torch.tensor(d))
    _close(got.numpy(), want, FP32_REL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_ref_twin(dtype, with_state):
    """d_skip, return_state and init_state; in bf16 the rank-5 operands are
    cast to the input dtype at the same places (rel. one bf16 step)."""
    B, S, H, P, N = 2, 64, 3, 16, 8
    x, dt, a, b, c = _case(B, S, H, P, N, seed=3)
    d = np.linspace(0.5, 1.5, H).astype(np.float32)
    s0 = (np.random.default_rng(4).normal(size=(B, H, P, N)) * 0.3
          ).astype(np.float32) if with_state else None
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want, ws = jref.ssd_chunked_ref(
        jnp.asarray(x, jd), jnp.asarray(dt), jnp.asarray(a),
        jnp.asarray(b, jd), jnp.asarray(c, jd), chunk=16,
        d_skip=jnp.asarray(d), return_state=True,
        init_state=None if s0 is None else jnp.asarray(s0))
    got, gs = tref.ssd_chunked_ref(
        torch.tensor(x).to(td), torch.tensor(dt), torch.tensor(a),
        torch.tensor(b).to(td), torch.tensor(c).to(td), chunk=16,
        d_skip=torch.tensor(d), return_state=True,
        init_state=None if s0 is None else torch.tensor(s0))
    rel = FP32_REL if dtype == "float32" else BF16_REL
    assert got.dtype == td and gs.dtype == torch.float32
    _close(got.float().numpy(), np.asarray(want, np.float32), rel)
    _close(gs.numpy(), ws, FP32_REL)
    # and the twin agrees with the per-token recurrence, seeded or not
    if dtype == "float32" and not with_state:
        naive = tref.ssd_ref(*map(torch.tensor, (x, dt, a, b, c)),
                             d_skip=torch.tensor(d))
        _close(got.numpy(), naive.numpy(), 2e-4)


def _jax_ssd_grads(ins, gy, chunk):
    def f(*args):
        return jnp.sum(jref.ssd_chunked_ref(*args, chunk=chunk) * gy)
    return jax.jit(jax.grad(f, argnums=(0, 1, 2, 3, 4)))(
        *map(jnp.asarray, ins))


@pytest.mark.parametrize("shape,chunk", [((2, 64, 3, 16, 8), 16),
                                         ((1, 128, 2, 32, 16), 32)])
def test_ssd_scan_function_grads_match_jax(shape, chunk):
    """``SSDScan``'s backward is the VJP of ``ssd_chunked_ref``: each of the
    five gradients within GRAD_REL of the largest entry of ``jax.grad``'s."""
    ins = _case(*shape, seed=5)
    gy = np.random.default_rng(6).normal(size=shape[:3] + (shape[3],)
                                         ).astype(np.float32)
    want = _jax_ssd_grads(ins, jnp.asarray(gy), chunk)
    ts = [torch.tensor(t, requires_grad=True) for t in ins]
    y = tss.SSDScan.apply(*ts, chunk)
    y.backward(torch.tensor(gy))
    for name, t, w in zip("x dt a b c".split(), ts, want):
        assert t.grad is not None and t.grad.shape == t.shape, name
        _close(t.grad.numpy(), w, GRAD_REL)


def test_ops_ssd_d_skip_and_grads_match_jax():
    """``ops.ssd`` (kernel + fp32 D-skip outside it) against the JAX CPU path
    ``ssd_chunked_ref(d_skip=)``: value and all six gradients."""
    x, dt, a, b, c = _case(2, 32, 2, 8, 8, seed=7)
    d = np.array([0.7, 1.3], np.float32)
    gy = np.random.default_rng(8).normal(size=x.shape).astype(np.float32)

    def f(*args):
        y = jref.ssd_chunked_ref(*args[:5], chunk=16, d_skip=args[5])
        return jnp.sum(y * gy), y
    (_, want), jg = jax.jit(jax.value_and_grad(f, argnums=tuple(range(6)),
                                               has_aux=True))(
        *map(jnp.asarray, (x, dt, a, b, c, d)))
    ts = [torch.tensor(t, requires_grad=True) for t in (x, dt, a, b, c, d)]
    y = t_ops.ssd(*ts[:5], chunk=16, d_skip=ts[5])
    (y * torch.tensor(gy)).sum().backward()
    _close(y.detach().numpy(), want, FP32_REL)
    for t, w in zip(ts, jg):
        _close(t.grad.numpy(), w, GRAD_REL)


def test_ssd_scan_function_gradcheck_fp64():
    """The Function's closed VJP is the true derivative of its forward:
    finite differences in fp64 at a tiny size (fp64 inputs run the plain
    forward and the chunked twin in fp64)."""
    rng = np.random.default_rng(9)
    B, S, H, P, N = 1, 8, 2, 3, 2
    x = rng.normal(size=(B, S, H, P))
    dt = np.log1p(np.exp(rng.normal(size=(B, S, H))))
    a = -np.exp(rng.uniform(size=(H,)))
    b, c = rng.normal(size=(B, S, N)), rng.normal(size=(B, S, N))
    ins = tuple(torch.tensor(t, dtype=torch.float64, requires_grad=True)
                for t in (x, dt, a, b, c))
    assert torch.autograd.gradcheck(lambda *t: tss.SSDScan.apply(*t, 4), ins,
                                    eps=1e-6, atol=1e-7, rtol=1e-6)


def test_ssd_scan_rejects_what_the_kernel_does_not_take():
    """A non-CPU, non-CUDA tensor raises; it never falls back."""
    x, dt, a, b, c = (torch.tensor(t) for t in _case(1, 16, 1, 4, 4))
    from _torch_elsewhere import elsewhere
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tss._launch(elsewhere(x), dt, a, b, c, 16)


def test_jax_ssd_scan_kernel_has_no_gradient():
    """Reference fault the port works around (ROADMAP queue 3): the Pallas
    call has no JVP rule, so ``jax.grad`` through ``ssd_scan`` raises even
    in interpret mode, while its forward matches ``ssd_chunked_ref``. The
    JAX package trains through the kernel only where ``ops.ssd`` takes it
    (a TPU); on the CPU it differentiates ``ssd_chunked_ref``, which is what
    ``SSDScan``'s backward reproduces."""
    ins = [jnp.asarray(t) for t in _case(1, 32, 1, 4, 4, seed=10)]
    fwd = jax_ssd_scan(*ins, chunk=16, interpret=True)
    _close(fwd, jref.ssd_chunked_ref(*ins, chunk=16), FP32_REL)
    with pytest.raises(AssertionError):        # _pallas_call_jvp_rule
        jax.grad(lambda x: jnp.sum(jax_ssd_scan(x, *ins[1:], chunk=16,
                                                interpret=True)))(ins[0])


def test_chunked_grads_finite_where_the_jax_twin_overflows():
    """Reference fault (ROADMAP queue 3): with a strong decay inside a chunk
    (here dt·a = -24 a token, so cum_t - cum_i > 88 above the diagonal)
    ``jax.grad`` of ``ssd_chunked_ref`` is NaN, because its masked
    ``exp(dec)`` overflows and the mask's gradient multiplies 0 by inf. The
    forward is unaffected. The port's twin takes the exp of the kept entries
    only: the same values, and gradients equal to ``jax.grad`` of the
    per-token recurrence ``ssd_ref`` (no exp of a positive number there)."""
    x, _, _, b, c = _case(1, 16, 2, 4, 4, seed=12)
    dt = np.full((1, 16, 2), 1.5, np.float32)
    a = np.array([-16.0, -1.0], np.float32)
    gy = np.random.default_rng(13).normal(size=x.shape).astype(np.float32)
    ins = (x, dt, a, b, c)
    jc = _jax_ssd_grads(ins, jnp.asarray(gy), 8)
    assert any(np.isnan(np.asarray(g)).any() for g in jc)

    def f(*args):
        return jnp.sum(jref.ssd_ref(*args) * gy)
    want = jax.jit(jax.grad(f, argnums=(0, 1, 2, 3, 4)))(
        *map(jnp.asarray, ins))
    ts = [torch.tensor(t, requires_grad=True) for t in ins]
    y = tss.SSDScan.apply(*ts, 8)
    y.backward(torch.tensor(gy))
    _close(y.detach().numpy(), jref.ssd_chunked_ref(
        *map(jnp.asarray, ins), chunk=8), FP32_REL)
    for t, w in zip(ts, want):
        assert torch.isfinite(t.grad).all()
        _close(t.grad.numpy(), w, GRAD_REL)
