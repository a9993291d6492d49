"""The tile walk of the port's tiled and tc ``flash_attention`` designs, on
the CPU.

The CUDA kernels take 64 query rows a block and visit key tiles of 128 keys
(tiled; tc for blocks of 1 or 2 query heads) or 64 (tc for blocks of 3,
and at hd 256); tc's row split (MHA) takes 128 query rows a block over
either key tile; which tiles they visit is a rule on the caller's (bq, bk)
block grid that ``tile_walk`` mirrors. Here the rule is held, for every
tile shape, to what the function needs:
every tile holding a kept entry (``block_runs & entry_mask``) and every tile
a still-masked row needs (its entries of running blocks weigh 1 while the
row has kept nothing), and attention computed from the visited tiles alone
equals ``flash_attention_plain`` and the Pallas kernel in interpret mode.
Also the design rule, ``select_flash_design``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels import flash_attention as fa

NEG_INF = -1e30
ATOL = 1e-5

# (Sq, Skv, kw, bq, bk): causal, window, stride-2 perforation, ragged
# Sq != Skv both ways, and caller grids that are not the kernel's tiles
CASES = {
    "causal": (512, 512, dict(causal=True), 128, 128),
    "causal-grid64": (300, 300, dict(causal=True), 64, 64),
    "full": (200, 333, dict(causal=False), 128, 128),
    "window": (640, 640, dict(causal=True, window=150), 128, 128),
    "window-grid48x80": (500, 500, dict(causal=True, window=97), 48, 80),
    "stride2": (1024, 1024, dict(causal=True, kv_keep_stride=2), 128, 128),
    "stride2-grid64": (700, 700, dict(causal=True, kv_keep_stride=2), 64,
                       64),
    "stride3-window": (900, 900, dict(causal=True, window=400,
                                      kv_keep_stride=3), 64, 32),
    "ragged-q-short": (100, 450, dict(causal=True, window=60), 64, 64),
    "ragged-q-long": (450, 130, dict(causal=True), 64, 128),
    "ragged-full": (77, 261, dict(causal=False), 32, 96),
    # the tc design's edge shapes on the card (chip_smoke.phi4_flash_cases)
    "card-ragged-q-long": (1500, 1000, dict(causal=True, window=300), 128,
                           128),
    "card-r8-window": (900, 1300, dict(causal=True, window=200), 128, 128),
    "card-stride2-hd64": (1100, 1100, dict(causal=True, kv_keep_stride=2),
                          128, 128),
    "card-grid48x80": (700, 500, dict(causal=True, window=97), 48, 80),
    # gemma3-12b's local layers (window 1024), cut from 8192 tokens
    "card-window1024": (2048, 2048, dict(causal=True, window=1024), 128,
                        128),
}

# (tile_q, tile_k) of each walk: "tiled" is also tc's walk for blocks of 1
# or 2 heads at hd <= 128, "tc64" tc's for blocks of 3 and at hd 256, and
# "tc-rows" / "tc-rows64" tc's row split (R 1: two 64-row query tiles of
# one head a block) over 128- and 64-key tiles
WALKS = {"tiled": (fa.TILE_Q, fa.TILE_K), "tc64": (64, 64),
         "tc-rows": (128, 128), "tc-rows64": (128, 64)}


def _by_walk(names):
    """The cases ``names`` over every walk; the tiled walk's keep their
    case's name as id."""
    return [pytest.param(n, w, id=n if w == "tiled" else f"{n}-{w}")
            for w in WALKS for n in names]


def _masks(Sq, Skv, kw, bq, bk, tile_k):
    """(Sq, keys) inc and keep on the padded key range of whole tiles."""
    bq, bk = min(bq, Sq), min(bk, Skv)
    n_kpad = -(-Skv // bk) * bk
    keys = torch.arange(-(-max(n_kpad, Skv) // tile_k) * tile_k)
    rows = torch.arange(Sq)
    mk = dict(causal=kw.get("causal", True), window=kw.get("window", 0))
    inc = fa.block_runs(rows, keys, kv_keep_stride=kw.get(
        "kv_keep_stride", 1), bq=bq, bk=bk, **mk) & (keys < n_kpad)[None]
    keep = inc & fa.entry_mask(rows, keys, n_kv=Skv, **mk)
    return inc, keep


def _walk(Sq, Skv, kw, bq, bk, tiles=WALKS["tiled"]):
    return fa.tile_walk(Sq, Skv, causal=kw.get("causal", True),
                        window=kw.get("window", 0),
                        kv_keep_stride=kw.get("kv_keep_stride", 1), bq=bq,
                        bk=bk, tile_q=tiles[0], tile_k=tiles[1])


@pytest.mark.parametrize("name,walk_of", _by_walk(CASES))
def test_walk_visits_every_tile_the_function_needs(name, walk_of):
    Sq, Skv, kw, bq, bk = CASES[name]
    tq, tk_ = WALKS[walk_of]
    inc, keep = _masks(Sq, Skv, kw, bq, bk, tk_)
    walks = _walk(Sq, Skv, kw, bq, bk, WALKS[walk_of])
    n_t = inc.shape[1] // tk_
    assert len(walks) == -(-Sq // tq)
    for qt, walk in enumerate(walks):
        assert walk == sorted(set(walk))
        rows = slice(qt * tq, (qt + 1) * tq)
        ti = inc[rows].reshape(-1, n_t, tk_).any(-1)    # (rows, tiles)
        tk = keep[rows].reshape(-1, n_t, tk_).any(-1)
        # a tile holding a kept entry
        assert set(torch.nonzero(tk.any(0)).flatten().tolist()) <= set(walk)
        # a tile where a row that has kept nothing before has a running entry
        kept_before = torch.cumsum(tk.int(), 1) - tk.int() > 0
        needed = (ti & ~kept_before).any(0)
        assert set(torch.nonzero(needed).flatten().tolist()) <= set(walk)
        # and nothing else
        assert set(walk) <= set(torch.nonzero(tk.any(0) | needed)
                                .flatten().tolist())


def _walk_attention(q, k, v, Sq, Skv, kw, bq, bk, tiles):
    """fp64 attention from the visited tiles' entries alone, as the kernels
    score them: kept entries by q.k / sqrt(hd) (soft-capped), masked
    entries of running blocks -1e30, the rest left out."""
    tq, tk = tiles
    inc, keep = _masks(Sq, Skv, kw, bq, bk, tk)
    walks = _walk(Sq, Skv, kw, bq, bk, tiles)
    n = inc.shape[1]
    visited = torch.zeros(Sq, n, dtype=torch.bool)
    for qt, walk in enumerate(walks):
        for t in walk:
            visited[qt * tq:(qt + 1) * tq, t * tk:(t + 1) * tk] = True
    qd, kd, vd = (torch.from_numpy(a).double() for a in (q, k, v))
    kd = torch.nn.functional.pad(kd, (0, 0, 0, n - Skv))
    vd = torch.nn.functional.pad(vd, (0, 0, 0, n - Skv))
    rep = q.shape[1] // k.shape[1]
    kd, vd = kd.repeat_interleave(rep, 1), vd.repeat_interleave(rep, 1)
    s = qd @ kd.transpose(-1, -2) * q.shape[-1] ** -0.5
    cap = kw.get("cap", 0.0)
    if cap:
        s = cap * torch.tanh(s / cap)
    s = torch.where(keep & visited, s,
                    torch.where(inc & visited, torch.tensor(NEG_INF,
                                                            dtype=s.dtype),
                                torch.tensor(float("-inf"), dtype=s.dtype)))
    m = s.amax(-1, keepdim=True).clamp_min(NEG_INF)
    p = torch.exp(s - m)
    return (p @ vd / p.sum(-1, keepdim=True).clamp_min(1e-30)).numpy()


@pytest.mark.parametrize("name,walk_of", _by_walk(
    ["causal-grid64", "window-grid48x80", "stride2-grid64", "stride3-window",
     "ragged-q-short", "ragged-q-long", "ragged-full"]))
def test_visited_tiles_give_the_function(name, walk_of):
    """Attention over the visited tiles equals the plain version (every
    case) and the Pallas kernel in interpret mode (its grid must divide the
    shapes: the 64 x 64 cases), GQA 4 query heads over 2 KV heads."""
    Sq, Skv, kw, bq, bk = CASES[name]
    kw = dict(kw, cap=20.0) if name == "window-grid48x80" else kw
    rng = np.random.default_rng(len(name))
    q = (rng.normal(size=(1, 4, Sq, 64)) * 0.3).astype(np.float32)
    k = (rng.normal(size=(1, 2, Skv, 64)) * 0.3).astype(np.float32)
    v = rng.normal(size=(1, 2, Skv, 64)).astype(np.float32)
    got = _walk_attention(q, k, v, Sq, Skv, kw, bq, bk, WALKS[walk_of])
    plain = fa.flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                     bq=bq, bk=bk, **kw).numpy()
    np.testing.assert_allclose(got, plain, rtol=0, atol=ATOL)
    if bq == bk == 64 and Sq % 64 == 0 == Skv % 64:
        want = np.asarray(jax_flash(*map(jnp.asarray, (q, k, v)),
                                    interpret=True, bq=64, bk=64, **kw))
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_walk_skips_what_causal_and_stride_leave_out():
    """The walk is not trivial: causal query tiles stop at the diagonal, a
    window starts late (tile 2 holds only masked entries of running blocks
    for the last rows, but comes before their first kept one), and stride
    2 leaves whole tiles out."""
    causal = _walk(512, 512, dict(causal=True), 128, 128)
    assert [w[-1] for w in causal] == [0, 0, 1, 1, 2, 2, 3, 3]
    window = _walk(640, 640, dict(causal=True, window=150), 128, 128)
    assert window[-1] == [2, 3, 4]
    stride = _walk(1024, 1024, dict(causal=True, kv_keep_stride=2), 128, 128)
    assert stride[-1] == [1, 3, 5, 6, 7]


@pytest.mark.parametrize("dtype,hd,design", [
    (torch.float32, 128, "tiled"), (torch.float32, 64, "tiled"),
    (torch.float32, 16, "simple"), (torch.float32, 80, "tiled"),
    (torch.float32, 256, "tiled"), (torch.bfloat16, 128, "tc"),
    (torch.bfloat16, 64, "tc"), (torch.float64, 128, "simple"),
    (torch.bfloat16, 16, "simple"), (torch.bfloat16, 80, "tc"),
    (torch.bfloat16, 256, "tc")])
def test_select_flash_design(dtype, hd, design):
    """Training attention (fp32) takes the tiled design and bf16 the tc one
    at hd 64, 80, 128 and 256 (whisper's, zamba2-2.7b's, phi4-mini's and
    gemma2-27b's, paligemma-3b's and gemma3-12b's heads); other dtypes and
    head sizes (fp64, which the card's wrapper refuses; the smoke configs'
    hd 16) the simple one."""
    assert fa.select_flash_design(dtype, hd) == design

