"""Unit cases of the counting mode (``repro_torch.cost``): a product's
2·M·N·K, a view's zero bytes, a pointwise op's bytes in and out, the live
peak of a known sequence of allocations and frees, and each kernel
wrapper's ``meta`` branch, which returns the kernel's outputs and enters
its ``work()``, while a CPU tensor still runs the plain version and enters
no kernel record."""
import pytest
import torch

from repro_torch import cost
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import int8_matmul as i8
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import quantize_rows as qr
from repro_torch.kernels import ring_attention as ra
from repro_torch.kernels import ssd_scan as ssd

META = torch.device("meta")


def _m(shape, dtype=torch.float32, device=META):
    return torch.empty(shape, dtype=dtype, device=device)


def test_matmul_counts_2mnk():
    a, b = _m((3, 4)), _m((4, 5))
    with cost.CountingMode() as mode:
        torch.mm(a, b)
        torch.bmm(_m((2, 3, 4)), _m((2, 4, 5)))
    assert mode.by_op["mm"][1] == 2 * 3 * 4 * 5
    assert mode.by_op["bmm"][1] == 2 * 2 * 3 * 4 * 5
    assert mode.by_op["mm"][2] == 4 * (12 + 20 + 15)
    assert mode.transcendentals == 0


def test_views_move_no_bytes():
    x = _m((8, 16))
    with cost.CountingMode() as mode:
        y = x.view(16, 8).transpose(0, 1)
        x[:, :4].expand(2, 8, 4)
        torch.split(y, 2)
    assert mode.flops == 0 and mode.bytes_accessed == 0
    assert mode.peak_bytes == 0


def test_pointwise_bytes_in_plus_out():
    x, y = _m((8, 16)), _m((8, 16))
    with cost.CountingMode() as mode:
        x + y
        torch.exp(x)
    assert mode.by_op["add"] == [1, 128.0, 3 * 128 * 4.0]
    assert mode.by_op["exp"][1:] == [0.0, 2 * 128 * 4.0]
    assert mode.transcendentals == 128
    # a broadcast operand is read at its own size
    with cost.CountingMode() as mode:
        x * _m((16,))
    assert mode.by_op["mul"][2] == 4 * (128 + 16 + 128)


def test_indexed_reads_and_writes_touch_their_rows():
    table, idx = _m((1000, 8)), torch.empty(5, dtype=torch.long,
                                            device=META)
    with cost.CountingMode() as mode:
        table[idx]
        table.index_copy_(0, idx, _m((5, 8)))
    assert mode.by_op["index"][2] == 5 * 8 + 2 * 5 * 8 * 4
    assert mode.by_op["index_copy_"][2] == 5 * 8 + 2 * 5 * 8 * 4


def test_live_peak_of_allocations_and_frees():
    u8 = torch.uint8
    with cost.CountingMode() as mode:
        a = _m((1000,), u8)               # 1024 after the 512-byte rounding
        b = _m((600,), u8)                # 1024
        del a
        c = _m((3000,), u8)               # 3072: live 4096
        v = c.view(3, 1000)               # a view allocates nothing
        del b
        d = _m((100,), u8)                # 512: live 3584
    assert mode.peak_bytes == 4096
    assert mode.live == 3072 + 512
    del c, v, d
    assert mode.live == 0


def test_arguments_made_outside_are_not_counted():
    x = _m((256, 256))
    with cost.CountingMode() as mode:
        x.add_(1.0)
        y = x * 2
    assert mode.peak_bytes == 256 * 256 * 4
    del y


def test_host_ops_are_not_counted():
    with cost.CountingMode() as mode:
        torch.ones(64) @ torch.ones(64)
        torch.ones(64).to(META)                   # a copy from the host
    assert mode.flops == 0 and not mode.by_op


def test_a_count_does_not_depend_on_what_ran_before():
    """RoPE caches its frequencies on the device at its first call (a copy
    from the host): the first count equals the second."""
    from repro_torch.models import common
    common._FREQS.clear()
    x, pos = _m((2, 8, 4, 16)), torch.empty(2, 8, dtype=torch.int32,
                                            device=META)
    counts = []
    for _ in range(2):
        with cost.CountingMode() as mode:
            common.apply_rope(x, pos, 10000.0)
        counts.append((mode.flops, mode.bytes_accessed, mode.peak_bytes,
                       dict(mode.by_op)))
    assert counts[0] == counts[1]


def _int8_operands(device, E=None, M=16, K=64, N=32):
    lead = () if E is None else (E,)
    gen = torch.Generator().manual_seed(0)
    x_q = torch.randint(-127, 128, lead + (M, K), generator=gen,
                        dtype=torch.int8)
    w_t = torch.randint(-127, 128, lead + (N, K), generator=gen,
                        dtype=torch.int8)
    xs = torch.rand(lead + (M, 1), generator=gen)
    ws = torch.rand(lead + (N, 1), generator=gen)
    return [t.to(device) for t in (x_q, xs, w_t, ws)]


def _meta_and_cpu(fn, make):
    """(meta outputs, meta records, cpu outputs, cpu records) of ``fn`` on
    operands ``make(device)``."""
    outs = {}
    for dev in ("meta", "cpu"):
        args = make(torch.device(dev))
        with cost.CountingMode() as mode:
            out = fn(*args)
        outs[dev] = (out, list(mode.kernels))
    return outs["meta"] + outs["cpu"]


@pytest.mark.parametrize("E", [None, 3])
def test_int8_matmul_meta_records_work(E):
    n0 = i8.launches
    out_m, rec_m, out_c, rec_c = _meta_and_cpu(
        lambda x, xs, w, ws: i8.int8_matmul_t(x, xs, w, ws),
        lambda d: _int8_operands(d, E))
    lead = () if E is None else (E,)
    assert out_m.device.type == "meta" and out_m.shape == lead + (16, 32)
    assert out_m.dtype == out_c.dtype == torch.bfloat16
    assert out_c.shape == out_m.shape
    assert rec_m == [cost.KernelRecord(
        "int8_matmul", "B", *i8.work(16, 64, 32, 2, E=E or 1))]
    assert rec_c == [] and i8.launches == n0
    # the (K, N) signature and the scale-free int32 sums
    x, xs, w_t, ws = _int8_operands(META)
    with cost.CountingMode() as mode:
        out = i8.int8_matmul(x, xs, w_t.t(), ws.t())
        acc = i8.int8_matmul_t(x, None, w_t, None, out_dtype=torch.float32)
    assert out.shape == acc.shape == (16, 32)
    assert [k.flops for k in mode.kernels] == [2.0 * 16 * 32 * 64] * 2
    assert mode.kernels[1].bytes == i8.work(16, 64, 32, 4, scales=False)[1]


def test_quantize_rows_meta_records_work():
    n0 = qr.launches

    def fn(x, ds):
        q, s = qr.quantize_rows(x)
        return q, s, qr.quantize_rows_backward(x, ds)
    (q, s, dx), rec_m, (qc, sc, dxc), rec_c = _meta_and_cpu(
        fn, lambda d: [torch.randn(8, 64).to(d),
                       torch.randn(8, 1).to(d)])
    assert (q.shape, q.dtype, s.shape, s.dtype) == \
        (qc.shape, qc.dtype, sc.shape, sc.dtype)
    assert dx.shape == dxc.shape == (8, 64)
    assert rec_m == [cost.KernelRecord("quantize_rows", "-",
                                       *qr.work(8, 64, 4)),
                     cost.KernelRecord("quantize_rows_backward", "-",
                                       *qr.work(8, 64, 4, backward=True))]
    assert rec_c == [] and qr.launches == n0


@pytest.mark.parametrize("dtype,design", [(torch.bfloat16, "tc"),
                                          (torch.float32, "tiled")])
def test_flash_attention_meta_records_work(dtype, design):
    n0 = fa.launches
    out_m, rec_m, out_c, rec_c = _meta_and_cpu(
        lambda q, k, v: fa.flash_attention(q, k, v, causal=True),
        lambda d: [torch.randn(1, 4, 200, 64).to(d, dtype),
                   torch.randn(1, 2, 200, 64).to(d, dtype),
                   torch.randn(1, 2, 200, 64).to(d, dtype)])
    assert out_m.shape == out_c.shape == (1, 4, 200, 64)
    pairs = fa.kept_pairs(200, 200, causal=True, window=0,
                          kv_keep_stride=1)
    assert pairs == 200 * 201 // 2
    assert rec_m == [cost.KernelRecord(
        "flash_attention", design,
        *fa.work(1, 4, 2, 200, 200, 64, dtype.itemsize, pairs))]
    assert rec_c == [] and fa.launches == n0


def test_ssd_scan_meta_records_work():
    n0, b0 = ssd.launches, ssd.backward_launches
    B, S, H, P, N, Q = 2, 64, 4, 8, 8, 16

    def make(d):
        g = torch.Generator().manual_seed(0)
        return [torch.randn(B, S, H, P, generator=g).to(d),
                torch.rand(B, S, H, generator=g).to(d) * 0.1,
                -torch.rand(H, generator=g).to(d),
                torch.randn(B, S, N, generator=g).to(d),
                torch.randn(B, S, N, generator=g).to(d)]

    def fn(x, dt, a, b, c):
        y = ssd.ssd_scan(x, dt, a, b, c, chunk=Q)
        grads = ssd.ssd_scan_backward(x, dt, a, b, c, y, chunk=Q)
        ys, st = ssd.ssd_scan_state(x[:, :45], dt[:, :45], a, b[:, :45],
                                    c[:, :45], chunk=Q)
        return y, grads, ys, st
    (y, grads, ys, st), rec_m, (yc, gc, ysc, stc), rec_c = _meta_and_cpu(
        fn, make)
    assert y.shape == yc.shape and ys.shape == ysc.shape == (B, 45, H, P)
    assert st.shape == stc.shape == (B, H, P, N)
    assert [g.shape for g in grads] == [g.shape for g in gc]
    assert rec_m == [
        cost.KernelRecord("ssd_scan", "-", *ssd.work(B, S, H, P, N, Q, 4)),
        cost.KernelRecord("ssd_scan_backward", "-",
                          *ssd.work_backward(B, S, H, P, N, Q, 4)),
        cost.KernelRecord("ssd_scan", "state",
                          *ssd.work_state(B, 45, H, P, N, Q, 4))]
    assert rec_c == []
    assert (ssd.launches, ssd.backward_launches) == (n0, b0)


def test_paged_attention_meta_records_work():
    n0 = pa.launches
    B, G, R, hd, P, M, n_pages = 2, 2, 2, 16, 4, 3, 8

    def make(d):
        g = torch.Generator().manual_seed(0)
        block = torch.tensor([[1, 2, 0], [3, 4, 5]], dtype=torch.int32)
        ppos = torch.arange(n_pages * P, dtype=torch.int32).view(n_pages, P)
        return [torch.randn(B, G, R, hd, generator=g).to(d),
                torch.randn(n_pages, P, G, hd, generator=g).to(d),
                torch.randn(n_pages, P, G, hd, generator=g).to(d),
                ppos.to(d), block.to(d),
                torch.tensor([6, 10], dtype=torch.int32).to(d)]
    out_m, rec_m, out_c, rec_c = _meta_and_cpu(pa.paged_attention, make)
    assert out_m.shape == out_c.shape == (B, G, R, hd)
    # no data on meta: every slot's whole block-table row is live
    assert rec_m == [cost.KernelRecord("paged_attention", "split+merge",
                                       *pa.work(B * M, B * M * P, P, G, R,
                                                hd, kv_bytes=4, batch=B,
                                                q_bytes=4, max_pages=M))]
    assert rec_c == [] and pa.launches == n0


def test_ring_hop_meta_records_work():
    n0 = ra.launches
    B, H, KVH, Cl, Ll, hd = 1, 4, 2, 8, 16, 16

    def make(d):
        g = torch.Generator().manual_seed(0)
        return [torch.randn(B, H, Cl, hd, generator=g).to(d),
                torch.randn(B, KVH, Ll, hd, generator=g).to(d),
                torch.randn(B, KVH, Ll, hd, generator=g).to(d),
                (torch.arange(Cl, dtype=torch.int32) + 8)[None].to(d),
                torch.arange(Ll, dtype=torch.int32)[None].to(d),
                torch.full((B, H, Cl, 1), -1e30).to(d),
                torch.zeros(B, H, Cl, 1).to(d),
                torch.zeros(B, H, Cl, hd).to(d)]
    out_m, rec_m, out_c, rec_c = _meta_and_cpu(ra.ring_hop, make)
    assert [t.shape for t in out_m] == [t.shape for t in out_c]
    assert rec_m == [cost.KernelRecord(
        "ring_hop", "simt", *ra.work(B, H, KVH, Cl, Ll, hd, 4, 4,
                                     B * Cl * Ll))]
    assert rec_c == [] and ra.launches == n0


def test_collective_records_and_roofline_pricing():
    from repro_torch import roofline
    from repro_torch.dist import collectives, implied
    with cost.CountingMode() as mode:
        collectives.WIRE.log("data", "all_reduce", 4, 1000)
        collectives.WIRE.log("pod", "all_gather", 2, 10)
        collectives.WIRE.log("data", "all_reduce", 1, 1000)  # moves nothing
        with implied.tracing(implied.Plan(model=4, split=frozenset({"mlp"}))):
            implied.row_out(_m((2, 8)), "mlp")
            implied.row_out(_m((2, 8)), "attn")            # not split
    kinds = [(r.kind, r.payload, r.source) for r in mode.collectives]
    assert kinds == [("all-reduce", 1000.0, "owned"),
                     ("all-gather", 20.0, "owned"),
                     ("all-reduce", 64.0, "implied")]
    assert roofline.collective_bytes(mode.collectives) == {
        "all-reduce": 2 * 1064.0, "all-gather": 20.0}
