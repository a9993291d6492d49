"""A JAX ``PagePool`` and the port's driven by the same calls, for the
twins of ``tests/test_pages_sharded.py`` and ``tests/test_pages_shrink.py``
(``tests/test_torch_pages_{sharded,shrink}.py``).

Every call goes to both pools; their results (admission plans, bools,
``migrate``'s ``perm``) must be equal, and after the call so must their
state: block tables, per-shard free lists, refcounts, slot pages, the
prefix index's entries in insertion order (its keys hash the pool's own
type, so they differ between packages; the entries do not), stats, budget
and scrub list. Reads (``slot_pages``, ``spec``, ...) answer from the
port's pool."""
import numpy as np

from repro.serve import pages as jax_pages
from repro_torch.serve import pages as t_pages


def state(pool):
    return dict(
        blocks=pool.blocks.tolist(), free=[list(d) for d in pool._free],
        ref=np.asarray(pool.ref).tolist(),
        slot_pages=[list(p) for p in pool.slot_pages],
        index=[(tuple(e.pages), e.n_tokens, e.last_use, e.hits)
               for e in pool.index.values()],
        stats=dict(pool.stats), reclaimed=pool.reclaimed,
        capacity_cut=pool.capacity_cut, limit=pool.limit,
        scrub=list(pool.scrub_pending), spec=tuple(vars(pool.spec).values()))


def _same(a, b):
    if isinstance(a, np.ndarray):
        assert np.array_equal(a, np.asarray(b)), (a, b)
    elif a is None or b is None:
        assert a is None and b is None, (a, b)
    elif hasattr(a, "shared_tokens"):          # AdmitPlan
        assert (a.shared_tokens, list(a.register), a.reserved_pages,
                a.entry is None) == (b.shared_tokens, list(b.register),
                                     b.reserved_pages, b.entry is None)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a == b, (a, b)


class TwinPool:
    """``spec_for(slots, max_len, page_size, n_pages, n_shards)`` pools of
    both packages; ``kw`` goes to both ``PagePool``s."""

    def __init__(self, slots, max_len, page_size, *, n_pages=0, n_shards=1,
                 pools=None, **kw):
        self.args = (slots, max_len, page_size)
        if pools is None:
            pools = tuple(
                m.PagePool(m.spec_for(slots, max_len, page_size, n_pages,
                                      n_shards=n_shards), slots, **kw)
                for m in (t_pages, jax_pages))
        self.t, self.j = pools
        self.check()

    def check(self):
        assert state(self.t) == state(self.j)

    def __getattr__(self, name):
        tv, jv = getattr(self.t, name), getattr(self.j, name)
        if not callable(tv):
            return tv

        def both(*a, **kw):
            rt, rj = tv(*a, **kw), jv(*a, **kw)
            _same(rt, rj)
            self.check()
            return rt
        return both

    def migrate(self, n_shards, **spec_kw):
        """Both pools migrated to ``n_shards`` (``spec_for`` of this pool's
        shape, or ``spec_kw`` overrides): (new TwinPool, perm), the perms
        equal."""
        slots, max_len, page_size = self.args
        args = dict(batch_slots=slots, max_len=max_len, page_size=page_size,
                    n_shards=n_shards)
        args.update(spec_kw)
        nt, pt = self.t.migrate(t_pages.spec_for(**args))
        nj, pj = self.j.migrate(jax_pages.spec_for(**args))
        _same(pt, pj)
        return TwinPool(*self.args, pools=(nt, nj)), pt
