"""The ring hop's kernel designs and its one-launch step, on the CPU.

``select_hop_design`` across dtypes and head widths; ``ring_hop_step``'s
argument checks; ``ring_hop_step`` on the CPU against ``ring_hop`` applied
pair by pair and against the Pallas ``_hop`` in interpret mode (state
updated in place, shards that do not run and rows that see nothing kept
exactly); the ring's step and hop counts; and a torch emulation of design
"tc"'s roundings (bf16 products summed in fp32, ``kv_scale`` applied after
the product, each 64-key tile's P.V summed on its own with P split into
bf16 hi and lo halves, added to the fp32 acc) held to the card check's
tolerance against ``ring_hop_plain`` at the ring cell's head widths, so the
unchanged tolerance is known reachable before any card run.

Tolerance: 1e-5 of the reference's largest entry, the card check's
``RING_REL``; the plain step and the pair-by-pair hops run the same code
and are held equal exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ring_attention as jax_ring
from repro_torch import configs as t_configs
from repro_torch.dist.sharding import prefill_plan
from repro_torch.kernels import ring_attention as ra
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.attention import KV_SCALE

RING_REL = 1e-5
BF16, F32, I8 = torch.bfloat16, torch.float32, torch.int8


@pytest.mark.parametrize("q_dtype,kv_dtype,hd,want", [
    (BF16, BF16, 128, "tc"), (BF16, I8, 128, "tc"), (BF16, BF16, 64, "tc"),
    (BF16, I8, 64, "tc"), (BF16, BF16, 32, "simt"), (BF16, BF16, 96, "simt"),
    (BF16, BF16, 256, "simt"), (BF16, F32, 128, "simt"),
    (F32, F32, 128, "simt"), (F32, BF16, 128, "simt"), (F32, I8, 64, "simt"),
])
def test_select_hop_design(q_dtype, kv_dtype, hd, want):
    assert ra.select_hop_design(q_dtype, kv_dtype, hd) == want


def _stacks(n, B, H, KVH, Cl, Ll, hd, int8, seed=0):
    """n shards of hop inputs: a carried non-trivial state (rows 0-3 still
    at the initial state), striped query positions, K/V positions with a
    hole and entries past the chunk unwritten (-1), an empty query row."""
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(n, B, H, Cl, hd)) * 0.5).astype(np.float32)
    if int8:
        k = rng.integers(-127, 128, (n, B, KVH, Ll, hd)).astype(np.int8)
        v = rng.integers(-127, 128, (n, B, KVH, Ll, hd)).astype(np.int8)
    else:
        k = (rng.normal(size=(n, B, KVH, Ll, hd)) * 0.5).astype(np.float32)
        v = rng.normal(size=(n, B, KVH, Ll, hd)).astype(np.float32)
    C = n * Cl
    qp = np.stack([np.broadcast_to(np.arange(d, C, n) + Ll, (B, Cl))
                   for d in range(n)]).astype(np.int32)
    qp[:, :, 3] = -1
    kvp = np.stack([np.broadcast_to(np.arange(d * Ll, (d + 1) * Ll), (B, Ll))
                    for d in range(n)]).astype(np.int32)
    kvp[kvp >= Ll + C] = -1
    kvp[:, :, 5:9] = -1
    m = rng.normal(size=(n, B, H, Cl, 1)).astype(np.float32)
    l = rng.uniform(0.5, 2.0, (n, B, H, Cl, 1)).astype(np.float32)
    acc = rng.normal(size=(n, B, H, Cl, hd)).astype(np.float32)
    m[:, :, :, :4], l[:, :, :, :4], acc[:, :, :, :4] = -1e30, 0.0, 0.0
    return q, k, v, qp, kvp, m, l, acc


STEP_CASES = {
    # name: (n, B, H, KVH, Cl, Ll, hd, window, cap, int8, pairs)
    "rotation": (4, 1, 4, 2, 12, 16, 16, 0, 0.0, False,
                 [(0, 3), (1, 0), (2, 1), (3, 2)]),
    "some-shards": (4, 2, 4, 1, 12, 16, 16, 0, 0.0, True,
                    [(0, 2), (3, 1)]),
    "window-cap-src-shared": (3, 1, 6, 2, 10, 20, 32, 12, 30.0, False,
                              [(2, 0), (0, 0)]),
}


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_ring_hop_step_equals_hops_pair_by_pair(name):
    n, B, H, KVH, Cl, Ll, hd, window, cap, int8, pairs = STEP_CASES[name]
    kvs = KV_SCALE if int8 else 0.0
    arrs = _stacks(n, B, H, KVH, Cl, Ll, hd, int8)
    t = [torch.tensor(a) for a in arrs]
    got = ra.ring_hop_step(*t, pairs, window=window, cap=cap, kv_scale=kvs)
    assert got[0] is t[5] and got[2] is t[7]               # in place
    ref = [torch.tensor(a) for a in arrs[5:]]
    for d, s in pairs:
        ra.ring_hop(t[0][d], t[1][s], t[2][s], t[3][d], t[4][s], ref[0][d],
                    ref[1][d], ref[2][d], window=window, cap=cap,
                    kv_scale=kvs)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    src_of = dict(pairs)
    for d in range(n):     # shards that did not run keep everything
        seen = (ra.visible(t[3][d], t[4][src_of[d]], window).any(-1)
                if d in src_of else torch.zeros(B, Cl, dtype=torch.bool))
        blind = (~seen)[:, None, :].expand(B, H, Cl).numpy()
        for i in (5, 6, 7):
            np.testing.assert_array_equal(got[i - 5][d].numpy()[blind],
                                          arrs[i][d][blind])
    assert ra.launches == 0


@pytest.mark.parametrize("name", ["rotation", "some-shards"])
def test_ring_hop_step_matches_pallas_interpret(name):
    n, B, H, KVH, Cl, Ll, hd, window, cap, int8, pairs = STEP_CASES[name]
    kvs = KV_SCALE if int8 else 0.0
    arrs = _stacks(n, B, H, KVH, Cl, Ll, hd, int8, seed=1)
    t = [torch.tensor(a) for a in arrs]
    ra.ring_hop_step(*t, pairs, window=window, cap=cap, kv_scale=kvs)
    for d, s in pairs:
        want = jax_ring._hop(*(jnp.asarray(a) for a in (
            arrs[0][d], arrs[1][s], arrs[2][s], arrs[3][d], arrs[4][s],
            arrs[5][d], arrs[6][d], arrs[7][d])), window=window, cap=cap,
            kv_scale=kvs, interpret=True)
        for g, w in zip(t[5:], want):
            w = np.asarray(w)
            np.testing.assert_allclose(g[d].numpy(), w, rtol=0,
                                       atol=RING_REL * np.abs(w).max())


def _bad_step(kind):
    arrs = [torch.tensor(a) for a in _stacks(4, 1, 4, 2, 12, 16, 16, False)]
    pairs = [(0, 3), (1, 0)]
    if kind == "dest-out-of-range":
        pairs = [(4, 0)]
    elif kind == "src-out-of-range":
        pairs = [(0, -1)]
    elif kind == "repeated-destination":
        pairs = [(1, 0), (1, 2)]
    elif kind == "fewer-kv-shards":
        arrs[1], arrs[2] = arrs[1][:3], arrs[2][:3]
    elif kind == "state-shape":
        arrs[7] = arrs[7][:, :, :, :, :8]
    elif kind == "positions-shape":
        arrs[4] = arrs[4][:, :, :10]
    elif kind == "unstacked-q":
        arrs[0] = arrs[0][0]
    return arrs, pairs


@pytest.mark.parametrize("kind,match", [
    ("dest-out-of-range", "out of range"), ("src-out-of-range", "out of range"),
    ("repeated-destination", "repeated destination"),
    ("fewer-kv-shards", "leading shard dimension"),
    ("state-shape", "acc must be"), ("positions-shape", "kvp must be"),
    ("unstacked-q", "leading shard dimension"),
])
def test_ring_hop_step_rejects(kind, match):
    arrs, pairs = _bad_step(kind)
    with pytest.raises(ValueError, match=match):
        ra.ring_hop_step(*arrs, pairs)


def test_ring_hop_step_rejects_other_devices():
    from _torch_elsewhere import elsewhere
    arrs = [elsewhere(torch.zeros(2, *t.shape[1:], dtype=t.dtype))
            for t in _bad_step("none")[0]]
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ra.ring_hop_step(*arrs, [(0, 1)])


def test_ring_counts_one_step_per_hop_with_a_running_shard():
    """A chunk at the start of the prompt: only the first K/V shard holds
    written entries, so every ring step runs one shard's hop and skips the
    rest. ``steps_run`` counts the steps with a running shard, as the
    card's launches do; on the CPU nothing launches."""
    rng = np.random.default_rng(0)
    B, C, G, R, hd, L = 1, 12, 2, 2, 16, 48
    q = torch.tensor(rng.normal(size=(B, C, G, R, hd)), dtype=torch.float32)
    k, v = (torch.tensor(rng.normal(size=(B, L, G, hd)), dtype=torch.float32)
            for _ in range(2))
    q_pos = torch.arange(C, dtype=torch.int32)[None]
    kv_pos = torch.where(torch.arange(L) < C, torch.arange(L), -1)[None]
    mesh = make_mesh((4, 1), ("data", "model"), "cpu")
    plan, _ = prefill_plan(t_configs.get_config("phi4-mini-3.8b-smoke"), mesh,
                           C)
    n = plan.n_shards
    ra.hops_run = ra.hops_skipped = ra.steps_run = ra.launches = 0
    ra.ring_chunk_attention(q, k, v, q_pos, kv_pos.to(torch.int32),
                            mesh=mesh, plan=plan)
    # K/V shard s holds positions [12 s, 12 s + 12): only shard 0 is written
    # and every striped query shard sees it, so hop t runs exactly the
    # destination d = t (src 0)
    assert (ra.hops_run, ra.hops_skipped, ra.steps_run) == (n, n * n - n, n)
    assert ra.launches == 0


# ------------------------------------------------- design "tc" emulated --

def _tc_hop(q, k, v, qp, kvp, m, l, acc, *, kv_scale, terms=2, tile=64):
    """Design "tc"'s arithmetic in torch: per 64-key tile, scores from bf16
    products summed in fp32 times scale * kv_scale; the online softmax in
    fp32; P times kv_scale split into ``terms`` bf16 parts, each part's
    product with the (bf16-exact) V summed in fp32 over the tile alone and
    added to acc * alpha in fp32; l sums the fp32 P."""
    B, H, Cl, hd = q.shape
    KVH, Ll = k.shape[1], k.shape[2]
    rep = H // KVH
    qf = q.float().reshape(B, KVH, rep, Cl, hd)
    kvs = kv_scale or 1.0
    m, l, acc = (t.reshape(B, KVH, rep, Cl, -1).clone() for t in (m, l, acc))
    for k0 in range(0, Ll, tile):
        kt = k[:, :, None, k0:k0 + tile].float()
        vt = v[:, :, None, k0:k0 + tile].float()
        mask = ra.visible(qp, kvp[:, k0:k0 + tile])[:, None, None]
        s = (qf @ kt.transpose(-1, -2)) * (hd ** -0.5 * kvs)
        s = torch.where(mask, s, ra.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.where(mask, torch.exp(s - m_new), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        rest, pv = p * kvs, torch.zeros_like(acc)
        for _ in range(terms):
            part = rest.to(torch.bfloat16).float()
            pv = pv + part @ vt
            rest = rest - part
        acc = acc * alpha + pv
        m = m_new
    return tuple(t.reshape(B, H, Cl, -1) for t in (m, l, acc))


def _rel_err(got, ref):
    return max(float((g - r).abs().max() / r.abs().max())
               for g, r in zip(got[1:], ref[1:]))


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_tc_roundings_stay_within_the_card_tolerance(kv_dtype):
    """At the ring cell's head widths (H 24, KVH 8, hd 128; Cl 64, Ll 512)
    with unit-scale inputs and a carried state, two terms of P reach
    RING_REL against ``ring_hop_plain`` and one does not: the split is what
    holds the fp32 contract."""
    B, H, KVH, Cl, Ll, hd = 1, 24, 8, 64, 512, 128
    rng = np.random.default_rng(3)
    q = torch.tensor(rng.normal(size=(B, H, Cl, hd)), dtype=BF16)
    if kv_dtype == "int8":
        k, v = (torch.tensor(rng.integers(-60, 61, (B, KVH, Ll, hd)),
                             dtype=I8) for _ in range(2))
        kvs = KV_SCALE
    else:
        k, v = (torch.tensor(rng.normal(size=(B, KVH, Ll, hd)), dtype=BF16)
                for _ in range(2))
        kvs = 0.0
    qp = torch.arange(Ll, Ll + 4 * Cl, 4, dtype=torch.int32)[None]
    qp[:, :2] = -1
    kvp = torch.arange(Ll, dtype=torch.int32)[None].clone()
    kvp[:, 100:140] = -1
    m = torch.tensor(rng.normal(size=(B, H, Cl, 1)) + 3, dtype=F32)
    l = torch.tensor(rng.uniform(50, 200, (B, H, Cl, 1)), dtype=F32)
    acc = torch.tensor(rng.normal(size=(B, H, Cl, hd)) * 5, dtype=F32)
    ref = ra.ring_hop_plain(q, k, v, qp, kvp, m.clone(), l.clone(),
                            acc.clone(), kv_scale=kvs)
    two = _tc_hop(q, k, v, qp, kvp, m, l, acc, kv_scale=kvs)
    one = _tc_hop(q, k, v, qp, kvp, m, l, acc, kv_scale=kvs, terms=1)
    assert _rel_err(two, ref) <= RING_REL, _rel_err(two, ref)
    assert _rel_err(one, ref) > RING_REL, _rel_err(one, ref)
    blind = (qp < 0)[:, None, :].expand(B, H, Cl)
    assert torch.equal(two[2][blind], acc[blind])
