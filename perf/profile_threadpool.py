#!/usr/bin/env python
"""Native threadpool microbenchmark — the analog of the reference's
`perf/benchmark_threadpool.cpp` / `profile_threadpool.out` (16 x 1 ms sleep
kernels on 4 threads, 96% efficiency).

Here the pool's production workload is the scenario generator
(`_native/src/altro_native.cpp:altro_generate_uniform`, the batch analog of
`KnotPoint::Random`), so the measurement uses that real kernel: generate a
large fleet of initial states with 1 thread vs all hardware threads and
report the speedup/efficiency.  Host thread count is whatever the machine
has (the reference's recorded run used 4).

Run: PYTHONPATH=. python perf/profile_threadpool.py
"""
import json
import os
import sys
import time

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

from altro_jax.native import ScenarioGenerator  # noqa: E402

BATCH = int(os.environ.get("POOL_BATCH", "2000000"))
DIM = 8


def timed(gen: ScenarioGenerator, reps: int = 7) -> float:
    lo = [-1.0] * DIM
    hi = [1.0] * DIM
    gen.uniform(BATCH, lo, hi, seed=0)  # warm
    walls = []
    for r in range(reps):
        t0 = time.perf_counter()
        gen.uniform(BATCH, lo, hi, seed=r)
        walls.append(time.perf_counter() - t0)
    return float(np.median(walls))


def main() -> None:
    g1 = ScenarioGenerator(nthreads=1)
    gN = ScenarioGenerator(nthreads=0)  # 0 = hardware threads
    nt = gN.num_threads
    t1 = timed(g1)
    tN = timed(gN)
    speedup = t1 / tN
    print(json.dumps({
        "metric": "native_threadpool_speedup",
        "value": round(speedup, 3),
        "unit": "x",
        "nthreads": nt,
        "efficiency_pct": round(100.0 * speedup / nt, 2),
        "batch": BATCH,
        "dim": DIM,
        "wall_1thread_s": round(t1, 4),
        "wall_pool_s": round(tN, 4),
        "workload": "scenario generation (altro_generate_uniform)",
    }), flush=True)


if __name__ == "__main__":
    main()
