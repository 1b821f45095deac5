"""Native runtime tests: build, profiler, threaded scenario generator.

Parity targets: profiler path semantics (`test/common/timer_test.cpp`),
threadpool mechanics (`test/common/threadpool_test.cpp`), determinism.
"""
import time

import numpy as np
import pytest

from altro_jax import native


@pytest.fixture(scope="module")
def lib():
    lib = native.load(build_if_missing=True)
    if lib is None:
        pytest.skip("native toolchain unavailable")
    return lib


def test_profiler_hierarchy(lib):
    prof = native.NativeProfiler()
    prof.set_active(True)
    with prof.scope("al"):
        with prof.scope("ilqr"):
            with prof.scope("backward_pass"):
                time.sleep(0.01)
            with prof.scope("forward_pass"):
                time.sleep(0.005)
    entries = prof.entries()
    assert "al" in entries
    assert "al/ilqr/backward_pass" in entries
    t_bp, count = entries["al/ilqr/backward_pass"]
    assert count == 1
    assert t_bp >= 9_000  # >= 9ms in microseconds
    assert entries["al"][0] >= t_bp


def test_profiler_inactive_is_free(lib):
    prof = native.NativeProfiler()
    prof.set_active(False)
    with prof.scope("x"):
        pass
    assert prof.entries() == {}


def test_profiler_overhead(lib):
    """Native start/stop pair should be far below the reference's ~10 µs
    (`timer.hpp:20-23`)."""
    prof = native.NativeProfiler()
    prof.set_active(True)
    n = 20000
    t0 = time.perf_counter()
    for _ in range(n):
        prof.start("k")
        prof.stop()
    per_pair_us = (time.perf_counter() - t0) / n * 1e6
    assert per_pair_us < 10.0


def test_scenario_generator_deterministic(lib):
    gen = native.ScenarioGenerator(nthreads=4)
    assert gen.num_threads == 4
    a = gen.uniform(1000, [-1.0, -2.0, 0.0], [1.0, 2.0, 3.0], seed=42)
    b = gen.uniform(1000, [-1.0, -2.0, 0.0], [1.0, 2.0, 3.0], seed=42)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (1000, 3)
    assert a[:, 0].min() >= -1.0 and a[:, 0].max() <= 1.0
    assert a[:, 2].min() >= 0.0 and a[:, 2].max() <= 3.0
    # different seed, different draw
    c = gen.uniform(1000, [-1.0, -2.0, 0.0], [1.0, 2.0, 3.0], seed=7)
    assert not np.array_equal(a, c)


def test_scenario_generator_threaded_matches_range(lib):
    gen1 = native.ScenarioGenerator(nthreads=1)
    gen8 = native.ScenarioGenerator(nthreads=8)
    a = gen8.uniform(100_000, [0.0], [1.0], seed=3)
    # uniform sanity: mean ~0.5
    assert abs(a.mean() - 0.5) < 0.01
    assert gen1.uniform(10, [0.0], [1.0], seed=3).shape == (10, 1)
