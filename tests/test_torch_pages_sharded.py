"""Slot-affinity invariants of the port's sharded page pool, with the JAX
package's pool driven through the same calls: twin of
``tests/test_pages_sharded.py``'s 8 cases (the hypothesis schedule
included). ``TwinPool`` (``tests/_torch_pages_twin.py``) requires equal
results, block tables, free lists, refcounts, prefix entries and stats
after every call; the assertions below are the JAX test's, on the port's
pool. The slot-affinity layout is what the sharded decode's per-shard
launches (``kernels.paged_attention.paged_attention_sharded``) rebase
against."""
import pytest

from tests._hypothesis_compat import HAVE_HYPOTHESIS, given, settings, st
from tests._torch_pages_twin import TwinPool

SLOTS, MAX_LEN, PSIZE, NSH = 8, 32, 4, 4


def mk_pool(n_shards=NSH, slots=SLOTS, n_pages=0):
    return TwinPool(slots, MAX_LEN, PSIZE, n_pages=n_pages,
                    n_shards=n_shards)


def check_affinity(tw):
    """assert_consistent plus the explicit cross-shard audit, on both."""
    tw.check()
    for pool in (tw.t, tw.j):
        pool.assert_consistent()
        for slot, pages in enumerate(pool.slot_pages):
            for p in pages:
                assert pool.page_shard(p) == pool.slot_shard(slot)
        for s, dq in enumerate(pool._free):
            assert all(pool.page_shard(p) == s for p in dq)
        for e in pool.index.values():
            assert len({pool.page_shard(p) for p in e.pages}) == 1


def test_spec_sizing_divides_shards():
    tw = mk_pool()
    spec = tw.spec
    assert spec.n_pages % NSH == 0
    assert spec.usable == spec.n_pages - NSH
    nulls = {s * spec.shard_pages for s in range(NSH)}
    assert not nulls & set(tw.t.free)


def test_admit_places_pages_on_owning_shard():
    tw = mk_pool()
    for slot in range(SLOTS):
        plan = tw.admit(slot, list(range(10 + slot)), "tag")
        assert plan is not None
        shard = tw.slot_shard(slot)
        assert all(tw.page_shard(p) == shard for p in tw.slot_pages[slot])
    check_affinity(tw)


def test_free_returns_pages_to_owning_shard():
    tw = mk_pool()
    for slot in range(SLOTS):
        assert tw.admit(slot, list(range(12)), slot) is not None
    before = [len(dq) for dq in tw.t._free]
    for slot in range(SLOTS):
        tw.free_slot(slot)
    tw.flush_prefixes()
    check_affinity(tw)
    after = [len(dq) for dq in tw.t._free]
    assert after == [b + 3 * (SLOTS // NSH) for b in before]


def test_decode_growth_stays_on_shard():
    tw = mk_pool()
    for slot in range(SLOTS):
        assert tw.admit(slot, list(range(6)), "t") is not None
        for pos in range(6, 6 + 3 * PSIZE):
            tw.ensure_decode_page(slot, pos)
        check_affinity(tw)


def test_release_window_and_replenish_never_migrate():
    tw = mk_pool()
    for slot in range(SLOTS):
        assert tw.admit(slot, list(range(16)), slot % 2) is not None
    owner = {p: tw.page_shard(p) for pages in tw.slot_pages for p in pages}
    for slot in range(SLOTS):
        tw.release_window_pages(slot, min_pos=2 * PSIZE - 1)
        check_affinity(tw)
    tw.replenish(low=tw.spec.usable, high=tw.spec.usable)
    check_affinity(tw)
    for p, s in owner.items():
        assert tw.page_shard(p) == s


def test_pressure_evicts_only_on_the_starved_shard():
    tw = mk_pool(n_pages=48)
    for slot in range(SLOTS):
        plan = tw.admit(slot, list(range(8)), slot)
        for b in plan.register:
            tw.register_prefix(slot, list(range(8)), slot, b)
        tw.free_slot(slot)
    assert len(tw.t.index) >= NSH

    def per_shard():
        return [sum(1 for e in tw.t.index.values()
                    if tw.t.page_shard(e.pages[0]) == s) for s in range(NSH)]
    before = per_shard()
    shard0_slots = [s for s in range(SLOTS) if tw.slot_shard(s) == 0]
    assert tw.admit(shard0_slots[0], list(range(MAX_LEN)), "fat") is not None
    check_affinity(tw)
    after = per_shard()
    assert after[0] < before[0]
    assert after[1:] == before[1:]


def test_single_shard_pool_unchanged():
    tw = mk_pool(n_shards=1)
    assert tw.spec.shard_pages == tw.spec.n_pages
    assert all(tw.slot_shard(s) == 0 for s in range(SLOTS))
    assert tw.admit(0, list(range(10)), "t") is not None
    check_affinity(tw)


@pytest.mark.skipif(not HAVE_HYPOTHESIS, reason="hypothesis not installed")
@settings(max_examples=60, deadline=None)
@given(st.lists(st.tuples(st.integers(0, 5), st.integers(0, SLOTS - 1),
                          st.integers(1, MAX_LEN - 2 * PSIZE),
                          st.integers(0, 2)),
                min_size=1, max_size=40))
def test_any_interleaving_keeps_slot_affinity(ops):
    """admit/decode/free/release/reclaim/replenish in any order: both pools
    agree after every call, stay consistent and keep slot affinity."""
    tw = mk_pool()
    pos = [0] * SLOTS
    for op, slot, length, tag in ops:
        if op == 0 and not tw.t.slot_pages[slot]:                  # admit
            if tw.admit(slot, list(range(length)), tag) is not None:
                pos[slot] = length
        elif op == 1 and tw.t.slot_pages[slot]:                    # decode
            for p in range(pos[slot],
                           min(pos[slot] + PSIZE + 1, MAX_LEN)):
                tw.ensure_decode_page(slot, p)
            pos[slot] = min(pos[slot] + PSIZE + 1, MAX_LEN)
        elif op == 2:                                              # free
            tw.free_slot(slot)
        elif op == 3 and tw.t.slot_pages[slot]:                    # window
            tw.release_window_pages(slot, min_pos=length - 1)
        elif op == 4:                                              # reclaim
            tw.set_reclaimed(tag)
        elif op == 5:                                              # churn
            tw.replenish()
        check_affinity(tw)
