"""The port's ``flash_attention`` at the head sizes of the full-width
configs that take the "tc" and "tiled" designs beside hd 64 and 128:
zamba2-2.7b's hd 80 (MHA) and paligemma-3b's and gemma3-12b's hd 256 (MQA
8:1, GQA 2:1 with gemma3's window), on the CPU. The same numpy inputs go
through the Pallas kernel in interpret mode (``bq = bk = 64``) and through
the port's wrapper, which takes its plain version for CPU tensors.

Tolerances: fp32 outputs within 1e-5 absolute, as
``tests/test_torch_flash.py`` (|out| <= ~4 here; the Pallas body's online
softmax and the plain version's one-pass softmax sum in other orders);
bf16 outputs within one bf16 step of the largest |out| (its ulp,
2^(floor(log2 max|out|) - 7)), since ``p`` is rounded to bf16 against a
running max in the kernel and the final max in the plain version, and an
output that lands next to a rounding boundary rounds one step apart."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels import flash_attention as fa

ATOL = 1e-5

# (B, H, KVH, S, hd, kw): hd 80 MHA causal and full; hd 256 MQA 8:1
# causal and full; hd 256 GQA 2:1 with a window and with a softcap
CASES = {
    "hd80-mha-causal": (1, 4, 4, 192, 80, dict(causal=True)),
    "hd80-mha-full": (1, 4, 4, 128, 80, dict(causal=False)),
    "hd256-mqa8-causal": (1, 8, 1, 128, 256, dict(causal=True)),
    "hd256-mqa8-full": (2, 8, 1, 128, 256, dict(causal=False)),
    "hd256-gqa2-window": (1, 4, 2, 256, 256, dict(causal=True, window=96)),
    "hd256-gqa2-softcap": (1, 4, 2, 256, 256, dict(causal=True, cap=30.0)),
}
# q scaled up where the case needs large scores: at the unit draw the scores
# q.k / sqrt(256) have an rms of ~0.09, where cap tanh(s / cap) moves a score
# by ~s^3 / (3 cap^2), far below the tolerance. At q x 64 (exact in bf16)
# their rms is ~5.8 and the largest reach the cap of 30: the softcap then
# moves the outputs by ~0.5.
Q_SCALE = {"hd256-gqa2-softcap": 64.0}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's ops here are small: one intra-op thread runs them faster
    than a pool that contends with the other test workers' for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(B, H, KVH, S, hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, S, hd)) * 0.3
    k = rng.normal(size=(B, KVH, S, hd)) * 0.3
    v = rng.normal(size=(B, KVH, S, hd))
    return [a.astype(np.float32) for a in (q, k, v)]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("name", list(CASES))
def test_flash_hd_plain_matches_pallas_interpret(name, dtype):
    B, H, KVH, S, hd, kw = CASES[name]
    q, k, v = _qkv(B, H, KVH, S, hd, seed=len(name))
    q = q * np.float32(Q_SCALE.get(name, 1.0))
    jdt = jnp.float32 if dtype == "fp32" else jnp.bfloat16
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    want = np.asarray(jax_flash(jq, jk, jv, interpret=True, bq=64, bk=64,
                                **kw), np.float32)
    tdt = torch.float32 if dtype == "fp32" else torch.bfloat16
    tq, tk, tv = (torch.tensor(np.asarray(a, np.float32)).to(tdt)
                  for a in (jq, jk, jv))
    got = fa.flash_attention(tq, tk, tv, bq=64, bk=64, **kw)
    assert got.dtype == tdt and got.shape == (B, H, S, hd)
    atol = ATOL if dtype == "fp32" else \
        2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=atol)
    # the card takes the fast designs at these widths, never "simple"
    assert fa.select_flash_design(tdt, hd) == ("tiled" if dtype == "fp32"
                                               else "tc")
