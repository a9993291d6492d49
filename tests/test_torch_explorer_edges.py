"""Twin of ``tests/test_explorer_edges.py``: the degenerate inputs of
``explorer.pareto_front`` and ``knobs.keep_groups`` through the port, each
also held equal to the JAX package's function on the same inputs."""
import pytest

from repro.approx.knobs import keep_groups as jax_keep_groups
from repro.core.explorer import pareto_front as jax_pareto_front
from repro_torch.approx.knobs import keep_groups
from repro_torch.core.explorer import pareto_front


def _front(pts):
    got = pareto_front(pts)
    assert got == jax_pareto_front(pts)
    return got


def _keep(n, skip):
    got = keep_groups(n, skip)
    assert tuple(got) == tuple(jax_keep_groups(n, skip))
    return got


# ------------------------------------------------------------ pareto_front --

def test_pareto_front_duplicate_points_kept_once():
    pts = [(0.1, 1.0), (0.1, 1.0), (0.1, 1.0)]
    front = _front(pts)
    assert len(front) == 1
    assert pts[front[0]] == (0.1, 1.0)


def test_pareto_front_all_dominated_by_one():
    # index 2 dominates every other point on both axes
    pts = [(0.5, 3.0), (0.4, 2.0), (0.0, 1.0), (0.9, 5.0)]
    assert _front(pts) == [2]


def test_pareto_front_empty_and_singleton():
    assert _front([]) == []
    assert _front([(0.3, 2.0)]) == [0]


def test_pareto_front_strict_frontier_sorted_by_quality_loss():
    # a real frontier: quality loss up, time down; dominated stragglers out
    pts = [(0.0, 5.0), (0.1, 3.0), (0.2, 4.0),   # (0.2, 4.0) dominated
           (0.3, 1.0), (0.3, 2.0)]               # tie on loss: faster wins
    front = _front(pts)
    assert front == [0, 1, 3]
    losses = [pts[i][0] for i in front]
    assert losses == sorted(losses)
    times = [pts[i][1] for i in front]
    assert times == sorted(times, reverse=True)


# -------------------------------------------------------------- keep_groups --

def test_keep_groups_precise_keeps_all():
    assert _keep(6, 0.0) == tuple(range(6))
    assert _keep(6, -1.0) == tuple(range(6))


@pytest.mark.parametrize("n", [2, 3, 7, 16])
@pytest.mark.parametrize("skip", [0.1, 0.25, 0.5, 0.75, 0.95])
def test_keep_groups_first_and_last_always_kept(n, skip):
    kept = _keep(n, skip)
    assert kept[0] == 0
    assert kept[-1] == n - 1
    assert list(kept) == sorted(set(kept)), "sorted, unique"


def test_keep_groups_extreme_skip_clamps_to_two():
    assert _keep(12, 0.99) == (0, 11)
    assert _keep(2, 0.99) == (0, 1)


def test_keep_groups_tiny_stacks():
    # a 1-group model can never drop its only group
    assert _keep(1, 0.5) == (0,)
    # skips too small to remove a whole group keep everything
    assert _keep(4, 0.1) == (0, 1, 2, 3)
