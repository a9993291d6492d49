"""The port's ``PagePool.migrate`` under elastic shrink and grow, with the
JAX package's pool driven through the same calls: twin of
``tests/test_pages_shrink.py``'s 6 cases (the hypothesis schedules
included). ``TwinPool`` (``tests/_torch_pages_twin.py``) requires equal
results (``perm`` among them), block tables, free lists, refcounts,
prefix entries and stats after every call; the migration contract below
is the JAX test's, held on the port's pools. The engine's ``_rehome``
permutes the paged caches' page axis by this ``perm``."""
import numpy as np
import pytest

from tests._hypothesis_compat import given, settings, st
from tests._torch_pages_twin import TwinPool

SLOTS = 4
MAX_LEN = 32
P = 4                                # page_size
MAX_PAGES = MAX_LEN // P


def make_pool(n_shards, reclaim_quantum=2):
    return TwinPool(SLOTS, MAX_LEN, P, n_shards=n_shards,
                    reclaim_quantum=reclaim_quantum)


def check_migration(old, new, perm):
    """The full migration contract between ``old`` and ``(new, perm)``,
    on the port's pools (``TwinPool`` already holds JAX's equal)."""
    old, new = old.t, new.t
    new.assert_consistent()
    assert new.index == {}, "prefix entries are evicted, never migrated"
    live = 0
    for slot in range(SLOTS):
        for lp in range(MAX_PAGES):
            o, n = int(old.blocks[slot, lp]), int(new.blocks[slot, lp])
            assert (o == 0) == (n == 0), (slot, lp, o, n)
            if o:
                live += 1
                assert perm[n] == o, (slot, lp, "perm must name the source")
                assert new.page_shard(n) == new.slot_shard(slot)
    dst = np.flatnonzero(perm >= 0)
    assert len(dst) == live
    nulls = {s * new.spec.shard_pages for s in range(new.spec.n_shards)}
    assert not (set(dst.tolist()) & nulls)
    assert old.capacity_cut == new.capacity_cut
    assert new.reclaimed == min(old.reclaimed, new.max_quanta)
    assert new.stats["elastic_migrations"] == \
        old.stats["elastic_migrations"] + 1


def test_migrate_preserves_live_layout_and_duplicates_shared_pages():
    pool = make_pool(1)
    rng = np.random.default_rng(0)
    base = list(map(int, rng.integers(1, 999, 8)))
    pool.admit(0, base + [7, 7], tag=0)
    pool.register_prefix(0, base + [7, 7], 0, 8)
    plan = pool.admit(1, base + [9], tag=0)
    assert plan.shared_tokens == 8
    shared = set(pool.slot_pages[0][:2])
    assert shared == set(pool.slot_pages[1][:2])
    pool.admit(2, [1, 2, 3], tag=0, reserve_tokens=8)
    pool.admit(3, [5], tag=0)
    pool.ensure_decode_page(3, 4)
    pool.assert_consistent()

    new, perm = pool.migrate(2)
    check_migration(pool, new, perm)
    a, b = new.slot_pages[0][:2], new.slot_pages[1][:2]
    assert not (set(a) & set(b)), "CoW collapses to copies on migration"
    assert all(int(new.t.ref[p]) == 1 for p in a + b)
    assert [perm[p] for p in a] == [perm[p] for p in b]

    back, perm2 = new.migrate(1)
    check_migration(new, back, perm2)


def test_migrate_carries_budget_floors_and_serves_after():
    pool = make_pool(2)
    pool.admit(0, [1, 2, 3, 4, 5], tag=0)
    pool.set_reclaimed(1)
    pool.set_capacity_cut(2)
    new, perm = pool.migrate(4)
    check_migration(pool, new, perm)
    assert new.capacity_cut == 2 and new.reclaimed >= 0
    assert new.admit(1, [9, 8, 7, 6, 5, 4], tag=0) is not None \
        or new.limit == 0
    new.set_capacity_cut(0)
    new.set_reclaimed(0)
    assert new.admit(2, [4, 4, 4], tag=0) is not None
    new.ensure_decode_page(2, 4)
    new.free_slot(0)
    new.assert_consistent()


def test_migrate_full_pool_no_leaks():
    for target in (1, 2, 4):
        pool = make_pool(1)
        for s in range(SLOTS):
            assert pool.admit(s, list(range(1, MAX_LEN)), tag=0) is not None
        pool.assert_consistent()
        new, perm = pool.migrate(target)
        check_migration(pool, new, perm)
        for s in range(SLOTS):
            new.free_slot(s)
        assert new.used == 0
        new.assert_consistent()


def test_migrate_rejects_shape_drift():
    pool = make_pool(1)
    with pytest.raises(AssertionError):
        pool.migrate(1, page_size=8)
    with pytest.raises(AssertionError):
        pool.migrate(1, max_len=MAX_LEN * 2)


# ------------------------------------------------------ random schedules --

OPS = ("admit", "admit_shared", "grow", "window", "free", "reclaim",
       "quota", "migrate")


def run_schedule(codes, seed):
    """The JAX test's op schedule on both pools, migrating across shard
    counts at each migrate op; the contract checked at each re-home."""
    rng = np.random.default_rng(seed)
    pool = make_pool(1)
    pos = {}
    shards = (1, 2, 4)
    migrations = 0
    for code in codes:
        op = OPS[code % len(OPS)]
        slot = int(rng.integers(SLOTS))
        if op in ("admit", "admit_shared") and slot not in pos:
            if op == "admit_shared":
                prompt = [11, 22, 33, 44] + \
                    list(map(int, rng.integers(1, 999,
                                               int(rng.integers(1, 5)))))
            else:
                prompt = list(map(int, rng.integers(
                    1, 999, int(rng.integers(1, MAX_LEN - 8)))))
            plan = pool.admit(slot, prompt, tag=0,
                              reserve_tokens=int(rng.integers(0, 9)))
            if plan is not None:
                pos[slot] = len(prompt)
                full = (len(prompt) // P) * P
                if full:
                    pool.register_prefix(slot, prompt, 0, min(full, P))
        elif op == "grow" and slot in pos and pos[slot] < MAX_LEN - 1:
            pos[slot] += 1
            pool.ensure_decode_page(slot, pos[slot])
        elif op == "window" and slot in pos:
            pool.release_window_pages(slot, max(pos[slot] - 8, 0))
        elif op == "free" and slot in pos:
            pool.free_slot(slot)
            del pos[slot]
        elif op == "reclaim":
            pool.set_reclaimed(int(rng.integers(0, pool.max_quanta + 1)))
        elif op == "quota":
            pool.set_capacity_cut(int(rng.integers(0, 3)))
        elif op == "migrate":
            target = shards[int(rng.integers(len(shards)))]
            new, perm = pool.migrate(target)
            check_migration(pool, new, perm)
            pool = new
            migrations += 1
        pool.assert_consistent()
    for slot in list(pos):
        pool.free_slot(slot)
    pool.flush_prefixes()
    assert pool.used == 0, "leaked pages after drain"
    pool.assert_consistent()
    return migrations


def test_deterministic_interleavings():
    codes = [0, 1, 2, 2, 7, 1, 0, 3, 5, 7, 2, 4, 6, 0, 7, 2, 4, 7, 5, 6,
             0, 1, 7, 4, 4]
    assert run_schedule(codes, seed=13) >= 2


@settings(max_examples=30, deadline=None)
@given(st.lists(st.integers(0, len(OPS) - 1), min_size=4, max_size=60),
       st.integers(0, 2 ** 16))
def test_random_interleavings_never_corrupt(codes, seed):
    run_schedule(codes, seed)
