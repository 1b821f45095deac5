#!/usr/bin/env python
"""MPC re-solve benchmark (BASELINE config 4: warm-started unicycle
re-solves at a 100 Hz budget).

Measures on the GPU:
  * single-controller warm-started re-solve latency (the reference's MPC
    workflow, `perf/benchmark_unicycle.cpp:45-75` — one solver re-solved
    in a loop with the previous trajectory/duals as the warm start);
  * a fleet of controllers stepping in lockstep — "many vehicles
    re-planning at 100 Hz", where the batch axis is what the device is for.

Run on the GPU host: python perf/benchmark_mpc.py
"""
import json
import os
import sys
import time

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import jax
import jax.numpy as jnp

from altro_jax import SolverOptions
from altro_jax.models.problems import UnicycleProblem
from altro_jax.models.unicycle import unicycle_rk4
from altro_jax.solver.mpc import MPC


def single(defn, prob, steps=60):
    mpc = MPC(prob, SolverOptions(), shift=True)
    # jit the plant step: eager dispatch costs one launch per tiny op of
    # the RK4 step
    model = jax.jit(unicycle_rk4())
    state = mpc.init(defn.initial_trajectory())
    x = jnp.zeros(3)
    lat = []
    for _ in range(steps):
        t0 = time.perf_counter()
        u0, state = mpc.step(state, x)
        jax.block_until_ready(u0)
        lat.append((time.perf_counter() - t0) * 1e3)
        x = model(x, u0, 0.0, defn.h)
    lat = np.asarray(lat[5:])
    dist = float(jnp.linalg.norm(x - jnp.asarray(defn.xf)))
    return {
        "mode": "single_controller",
        "resolve_ms_median": round(float(np.median(lat)), 3),
        "resolve_ms_p95": round(float(np.percentile(lat, 95)), 3),
        "within_10ms_budget_pct": round(float((lat < 10.0).mean() * 100), 1),
        "final_goal_dist_m": round(dist, 5),
    }


def fleet(defn, prob, B=4096, steps=12):
    """Lane-major fleet via BatchedMPC (the batch-last fleet controller).

    A vmapped per-instance `MPC.step` (batch-first layout, tiny per-knot
    matrices) is orders of magnitude slower; `BatchedMPC` re-solves the whole fleet as one lane-major program per
    tick instead.
    """
    from altro_jax import BatchedMPC
    from altro_jax.solver.batched import to_batch_last

    # Real-time per-tick budget: cap total iterations per step.  The fleet
    # tick is lockstep, so without the cap the handful of never-converging
    # instances run to the 300-iteration cap EVERY tick (measured 757 ms
    # vs ~30 ms; warm-start p50 is 2 iterations).  Capped instances report
    # MAX_ITERATIONS that tick and keep improving across ticks.
    mpc = BatchedMPC(prob, SolverOptions(
        backward_pass="fused", forward_pass="pallas", scan_unroll=4,
        max_iterations_total=10, max_iterations_inner=10,
    ), shift=True)
    model = jax.jit(jax.vmap(
        lambda x, u: unicycle_rk4()(x, u, 0.0, defn.h), in_axes=-1, out_axes=-1
    ))

    Z0 = defn.initial_trajectory()
    Zb = to_batch_last(jax.tree_util.tree_map(
        lambda l: jnp.broadcast_to(l, (B,) + l.shape), Z0
    ))
    state = mpc.init(Zb)
    rng = np.random.default_rng(0)
    xB = jnp.asarray(rng.uniform(-0.1, 0.1, size=(3, B)), jnp.float32)

    u0, state = mpc.step(state, xB)  # compile
    jax.block_until_ready(u0)
    lat = []
    solved = 0
    for _ in range(steps):
        t0 = time.perf_counter()
        u0, state = mpc.step(state, xB)
        jax.block_until_ready(u0)
        lat.append((time.perf_counter() - t0) * 1e3)
        xB = model(xB, u0)
        from altro_jax import SolverStatus

        solved = int((np.asarray(state.status) == int(SolverStatus.SOLVED)).sum())
    lat = np.asarray(lat[3:])
    med = float(np.median(lat))
    return {
        "mode": f"fleet_{B}_controllers_batched",
        "step_ms_median": round(med, 3),
        "step_ms_p95": round(float(np.percentile(lat, 95)), 3),
        "within_10ms_budget_pct": round(float((lat < 10.0).mean() * 100), 1),
        "controller_steps_per_s": round(B * 1000.0 / med, 1),
        "fleet_solved_last_tick": solved,
        "warm_iters_p50": float(np.percentile(np.asarray(state.iterations), 50)),
    }


def main() -> None:
    from altro_jax.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    defn = UnicycleProblem(dtype=jnp.float32)
    prob = defn.make_problem(add_constraints=True).compile()
    print(json.dumps(single(defn, prob)), flush=True)
    print(json.dumps(fleet(defn, prob)), flush=True)


if __name__ == "__main__":
    main()
