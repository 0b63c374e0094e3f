"""The open-loop schedule is a function of the mix and the seed, every
seed sends the same sizes and gaps in another order, and every block of
the window carries the same load."""
import numpy as np
import pytest

from perfbench.loadgen import schedule

MIX = {"rate_rps": 50, "size_min": 1, "size_max": 128, "block_s": 0.5}


@pytest.mark.parametrize("seed", [0, 2**31 + 5, 2**40 + 3])
def test_schedule_repeats_for_a_seed(seed):
    d1, n1 = schedule(MIX, seed, 4.0, 1000)
    d2, n2 = schedule(MIX, seed, 4.0, 1000)
    assert np.array_equal(d1, d2)
    assert all(np.array_equal(a, b) for a, b in zip(n1, n2, strict=True))


def test_seeds_share_sizes_and_gaps():
    d1, n1 = schedule(MIX, 1, 4.0, 1000)
    d2, n2 = schedule(MIX, 2, 4.0, 1000)
    assert sorted(map(len, n1)) == sorted(map(len, n2))
    assert not np.array_equal(d1, d2)
    assert len(d1) == len(d2) == 200
    g1, g2 = np.sort(np.diff(d1)), np.sort(np.diff(d2))
    assert np.isclose(np.median(g1), np.median(g2), rtol=0.05)


def test_schedule_shape():
    due, nodes = schedule(MIX, 7, 4.0, 300)
    assert due[0] == 0.0 and np.all(np.diff(due) >= 0) and due[-1] < 4.0
    sizes = [len(k) for k in nodes]
    assert min(sizes) == 1 and max(sizes) == 128
    for k in nodes:
        assert len(np.unique(k)) == len(k)
        assert k.min() >= 0 and k.max() < 300


@pytest.mark.parametrize("seed", [3, 2**33 + 1])
def test_every_block_carries_the_same_load(seed):
    due, nodes = schedule(MIX, seed, 4.0, 1000)
    per = 25   # rate_rps * block_s
    assert len(due) == 8 * per
    starts = due[::per]
    assert np.allclose(starts, 0.5 * np.arange(8))
    sizes = np.array([len(k) for k in nodes]).reshape(8, per)
    assert all(sorted(row) == sorted(sizes[0]) for row in sizes)
