"""content/synthetic against the repository's headline generator."""
import numpy as np
import pytest

import bench
import harness


@pytest.mark.parametrize("w, h, n", [(64, 64, 3), (720, 576, 2), (1920, 1152, 1)])
def test_synthetic_at_seed_42_is_bench_make_frames(w, h, n):
    got = harness.load("content", "synthetic").make(w, h, n, 42)
    want = bench.make_frames(w, h, n)
    assert len(got) == n
    for g, f in zip(got, want):
        for a, b in zip(g, f):
            assert a.dtype == np.uint8 and np.array_equal(a, b)


def test_synthetic_pool_cycles_seamlessly():
    mod = harness.load("content", "synthetic")
    frames = mod.make(64, 64, mod.PERIOD + 1, 7)
    for a, b in zip(frames[0], frames[mod.PERIOD]):
        assert np.array_equal(a, b)


def test_synthetic_seed_changes_texture_not_sizes():
    mod = harness.load("content", "synthetic")
    a, b = mod.make(64, 64, 1, 2 ** 31 + 5)[0], mod.make(64, 64, 1, 3)[0]
    assert [p.shape for p in a] == [p.shape for p in b]
    assert not np.array_equal(a[0], b[0])
