"""The page split of the port's ``paged_attention`` kernel, on the CPU.

The CUDA kernel cuts each block-table row into ranges of ``page_splits``
pages; a block's warps fold the range's running pages into their own online
softmax (page m0 + w, m0 + w + 4, ...), a page at a time or, where a page
is too large for shared memory, a tile of its rows at a time, merge their
states in warp order, and a second kernel merges the ranges of a (slot, KV
head) in range order. Here that walk is emulated in plain PyTorch, in fp32
as the kernel computes it, and held to ``paged_attention_plain`` and to the
Pallas kernel in interpret mode on the same numpy inputs (2e-5: fp32 sums
in another order), inactive rows included. The emulation does not model
the copies in flight (they change no sum). The shared-memory plan that
picks the tile rows is the CUDA source's, checked on the card (``-m
cuda``, where the JAX package is not installed: it is imported inside the
test that needs it)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import paged_attention as t_pa
from repro_torch.models import attention as t_attn

NEG_INF = -1e30
WARPS = 4             # kernel 1's warps a block
ATOL = 2e-5
SERVE = (8, 8, 64)    # (B, G, M): the serve cell's decode
RING = (4, 8, 1024)   # the ring cell's decode: 16384 tokens of 16-token pages
H100_SMS = 132


def _ranges(M, pps):
    return [(m0, min(m0 + pps, M)) for m0 in range(0, max(M, 1), pps)]


@pytest.mark.parametrize("B,G,M", [SERVE, RING, (1, 1, 1), (3, 2, 0),
                                   (64, 8, 256), (2, 4, 4097), (7, 3, 10)])
@pytest.mark.parametrize("n_sm", [1, H100_SMS])
def test_split_covers_every_page_once(B, G, M, n_sm):
    pps = t_pa.page_splits(B, G, M, n_sm)
    assert pps >= t_pa.MIN_SPLIT_PAGES
    pages = [m for m0, m1 in _ranges(M, pps) for m in range(m0, m1)]
    assert pages == list(range(M))


@pytest.mark.parametrize("B,G,M", [SERVE, RING])
def test_split_fills_the_card_at_both_cells(B, G, M):
    """At least ~2 blocks an SM (before empty ranges exit), and every range
    holds a page for each warp."""
    pps = t_pa.page_splits(B, G, M, H100_SMS)
    blocks = B * G * len(_ranges(M, pps))
    assert blocks >= 2 * H100_SMS, (pps, blocks)
    assert pps >= WARPS


@pytest.mark.parametrize("bad", [torch.tensor(8), np.int64(8), 8.0, "8"])
def test_split_takes_ints_only(bad):
    """Shapes only: a tensor (whose value the host would wait for) or any
    other non-int is refused."""
    with pytest.raises(TypeError):
        t_pa.page_splits(bad, 8, 64, H100_SMS)
    with pytest.raises(TypeError):
        t_pa.page_splits(8, 8, bad, H100_SMS)


def _inputs(lengths, *, P, M, G, R, hd, quantized, blind=(), seed=0):
    """Slots holding ``lengths[b]`` tokens (ragged, partial last pages, the
    decode entry at position ``lengths[b]`` written), two speculative
    future pages each filled with large values, then ``blind`` slots
    (position, mapped pages) whose pages hold no valid entry; a position
    with 0 mapped pages is a slot with no running page."""
    rng = np.random.default_rng(seed)
    B = len(lengths) + len(blind)
    n_pages = 1 + B * M
    kp = rng.normal(size=(n_pages, P, G, hd)) * 0.3
    vp = rng.normal(size=(n_pages, P, G, hd))
    block = np.zeros((B, M), np.int32)
    ppos = np.full((n_pages, P), -1, np.int32)
    pid = 1
    for b, L in enumerate(lengths):
        live = -(-(L + 1) // P)
        for lp in range(min(live + 2, M)):
            block[b, lp] = pid
            if lp < live:
                top = min(L + 1, (lp + 1) * P)
                ppos[pid, :top - lp * P] = np.arange(lp * P, top)
            else:
                kp[pid], vp[pid] = 1e3, -1e3
            pid += 1
    position = list(lengths)
    for b, (pos, n_mapped) in enumerate(blind, start=len(lengths)):
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


def _fold(state, s, v):
    """One page into an online-softmax state (m, l, acc), as a warp does:
    s (R, P) scores, v (P, hd) values."""
    m, l, acc = state
    mn = torch.maximum(m, s.max(-1).values)
    alpha = torch.exp(m - mn)
    e = torch.exp(s - mn[:, None])
    return mn, l * alpha + e.sum(-1), acc * alpha[:, None] + e @ v


def _merge(states):
    """States merged in the given order: m = max m_i, l and acc summed
    with weights exp(m_i - m)."""
    m = torch.stack([st[0] for st in states]).max(0).values
    l = sum(torch.exp(st[0] - m) * st[1] for st in states)
    acc = sum(torch.exp(st[0] - m)[:, None] * st[2] for st in states)
    return m, l, acc


def _emulate(q, kp, vp, ppos, block, position, *, window, kv_scale, cap,
             pps, tile=0):
    """The kernels' walk in plain PyTorch, folding each page in tiles of
    ``tile`` rows (0: whole pages). Returns the output and the partial
    (m, l, acc) of every (slot, head, range)."""
    B, G, R, hd = q.shape
    P = ppos.shape[1]
    M = block.shape[1]
    sc = hd ** -0.5 * (kv_scale or 1.0)
    out = torch.zeros(B, G, R, hd)
    partials = {}
    for b in range(B):
        pos = int(position[b])
        for g in range(G):
            ranges = []
            for s, (m0, m1) in enumerate(_ranges(M, pps)):
                warps = []
                for w in range(WARPS):
                    st = (torch.full((R,), NEG_INF), torch.zeros(R),
                          torch.zeros(R, hd))
                    for m in range(m0 + w, m1, WARPS):
                        pid = int(block[b, m])
                        run = pid != 0 and m * P <= pos
                        if window:
                            run = run and (m + 1) * P - 1 > pos - window
                        if not run:
                            continue
                        k = kp[pid, :, g].float()
                        x = (q[b, g].float() @ k.T) * sc
                        if cap:
                            x = cap * torch.tanh(x / cap)
                        kv = ppos[pid].long()
                        valid = (kv >= 0) & (kv <= pos)
                        if window:
                            valid &= kv > pos - window
                        x = torch.where(valid[None], x, NEG_INF)
                        v = vp[pid, :, g].float()
                        for t0 in range(0, P, tile or P):
                            t1 = t0 + (tile or P)
                            st = _fold(st, x[:, t0:t1], v[t0:t1])
                    warps.append(st)
                m_, l_, acc_ = _merge(warps)
                partials[b, g, s] = (m_, l_, acc_ * (kv_scale or 1.0))
                ranges.append(partials[b, g, s])
            m_, l_, acc_ = _merge(ranges)
            out[b, g] = acc_ / l_.clamp_min(1e-30)[:, None]
    return out, partials


# (lengths, P, M, G, R, hd, window, cap, quantized): phi4-mini's GQA group
# (R 3) at smoke width; softcap with a window; int8 K/V; a page size of 16
CASES = {
    "ragged": ([0, 5, 9, 14, 20, 37, 61], 4, 18, 2, 3, 16, 0, 0.0, False),
    "window+softcap": ([3, 12, 29, 44, 70], 4, 20, 2, 2, 32, 9, 30.0, False),
    "int8": ([1, 17, 33, 50, 66], 4, 20, 2, 3, 16, 0, 0.0, True),
    "int8+window": ([6, 31, 58], 8, 10, 1, 4, 16, 13, 0.0, True),
    "page16": ([15, 16, 17, 100, 250], 16, 20, 2, 3, 32, 0, 0.0, False),
}
BLIND = [(7, 0), (18, 5)]     # no running page; running pages all empty


@pytest.mark.parametrize("n_sm", [H100_SMS, 8])
@pytest.mark.parametrize("name", list(CASES))
def test_split_walk_matches_plain_and_pallas(name, n_sm):
    """On the H100 every warp takes one page of a short range; on a
    8-SM card the ranges are long and each warp folds several pages."""
    lengths, P, M, G, R, hd, window, cap, quantized = CASES[name]
    arrs = _inputs(lengths, P=P, M=M, G=G, R=R, hd=hd, quantized=quantized,
                   blind=BLIND)
    t = [torch.from_numpy(a) for a in arrs]
    kv_scale = t_attn.KV_SCALE if quantized else 0.0
    kw = dict(window=window, kv_scale=kv_scale, cap=cap)
    pps = t_pa.page_splits(len(lengths) + len(BLIND), G, M, n_sm)
    assert len(_ranges(M, pps)) >= 2          # the split really splits
    got, partials = _emulate(*t, pps=pps, **kw)
    plain = t_pa.paged_attention_plain(*t, **kw)
    import jax.numpy as jnp
    from repro.kernels import paged_attention as jax_pa
    want = jax_pa.paged_attention(*map(jnp.asarray, arrs), interpret=True,
                                  **kw)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    # the slot with no running page: every range carries l = 0, out zeros
    nb = len(lengths)
    assert all(float(p[1].abs().max()) == 0 for (b, _, _), p
               in partials.items() if b == nb)
    assert float(got[nb].abs().max()) == 0
    # the blind slot: its ranges carry m = -1e30, l = their entry count and
    # acc = the sum of V over those entries, and the output is their mean
    pos, n_mapped = BLIND[1]
    for (b, g, s), (m_, l_, acc_) in partials.items():
        if b != nb + 1:
            continue
        m0, m1 = _ranges(M, pps)[s]
        pages = [m for m in range(m0, min(m1, n_mapped)) if m * P <= pos
                 and (not window or (m + 1) * P - 1 > pos - window)]
        assert torch.all(m_ == NEG_INF) and torch.all(l_ == len(pages) * P)
        vsum = sum((t[2][int(arrs[4][b, m]), :, g].float().sum(0)
                    for m in pages), torch.zeros(hd)) * (kv_scale or 1.0)
        np.testing.assert_allclose(acc_.numpy(),
                                   vsum.expand(R, hd).numpy(), atol=1e-4)
    assert float(got[nb + 1].abs().max()) > 0


@pytest.mark.parametrize("n_sm", [H100_SMS, 8])
@pytest.mark.parametrize("name", list(CASES))
def test_split_walk_in_page_tiles_matches_plain(name, n_sm):
    """Pages folded a tile of rows at a time, as the kernel stages a page
    too large for shared memory (about a third of a page a tile, the last
    one shorter), give the same output: a tile whose entries are all masked
    carries m = -1e30 beside a valid one of its page, as a page does beside
    a valid page, and the inactive rows keep their zeros and mean of V."""
    lengths, P, M, G, R, hd, window, cap, quantized = CASES[name]
    arrs = _inputs(lengths, P=P, M=M, G=G, R=R, hd=hd, quantized=quantized,
                   blind=BLIND)
    t = [torch.from_numpy(a) for a in arrs]
    kw = dict(window=window, kv_scale=t_attn.KV_SCALE if quantized else 0.0,
              cap=cap)
    pps = t_pa.page_splits(len(lengths) + len(BLIND), G, M, n_sm)
    tile = -(-P // 3)
    assert tile < P                            # the pages really are cut
    got, _ = _emulate(*t, pps=pps, tile=tile, **kw)
    whole, _ = _emulate(*t, pps=pps, **kw)
    plain = t_pa.paged_attention_plain(*t, **kw)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), atol=ATOL, rtol=0)
    assert float(got[len(lengths)].abs().max()) == 0


@pytest.mark.cuda
def test_smem_plan_fits_every_paged_shape_of_the_paths():
    """Kernel 1 stages whole pages at every K/V dtype of the serving paths
    (phi4-mini hd 128 and the smoke hd 16, pages of 4 and 16) and at bf16
    hd 256, and equal tiles of a page where its two stages a warp would not
    fit, so every page size runs: those the earlier kernel (a block per
    slot and head, its page staged in fp32) took at its limits, and larger.
    The plan is the CUDA source's, so this runs on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the shared-memory plan is in the "
                    "CUDA source, built with nvcc")
    for esize in (4, 2, 1):
        for hd, P in ((128, 16), (16, 4), (16, 16)):
            assert t_pa.tile_rows(P, hd, esize) == P, (esize, hd, P)
    assert t_pa.tile_rows(16, 256, 2) == 16
    assert t_pa.tile_rows(16, 256, 4) == 8
    assert t_pa.tile_rows(64, 128, 4) == 22     # tiles of 22, 22 and 20
    for P, hd in ((112, 256), (205, 128), (391, 69), (4096, 256)):
        for esize in (4, 2, 1):
            pt = t_pa.tile_rows(P, hd, esize)
            tiles = -(-P // pt)
            assert 1 <= pt <= P and -(-P // tiles) == pt, (P, hd, esize, pt)
    assert t_pa.tile_rows(16, 257, 4) == 0
