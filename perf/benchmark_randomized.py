#!/usr/bin/env python
"""Randomized unicycle+obstacle fleet throughput (BASELINE config 5).

The north-star fleet workload: thousands of MPC scenarios with per-instance
initial states, obstacle layouts, AND goal references solved as one batched
program — the batched replacement for the reference looping over distinct
problem objects (altro-cpp's `perf/benchmark_unicycle.cpp:45-75`).

The kernels read per-instance param leaves as lane vectors
(`ops/forward_pallas.py::param_sig`), so this benchmark runs with the
SHIPPED kernels — asserted below, not assumed.

Per-instance randomization (seeded, reproducible):
  * x0 ~ U(-0.1, 0.1)^3                      (initial states)
  * obstacle centers jittered +-0.2, radii x U(0.8, 1.1)   (layouts)
  * goal x,y + U(0, 0.3), theta +- 0.3, entering the goal constraint AND
    the tracking-cost references q/c (stacked per-knot + per-instance —
    the hardest streaming layout)
Goal jitter is upward-only so no goal lands inside an inflated obstacle
(max obstacle reach 2.45 + 0.47 < 3.0): every instance stays feasible.

Run on the GPU host: python perf/benchmark_randomized.py
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

import bench
from altro_jax import SolverStatus
from altro_jax.models.problems import UnicycleProblem
from altro_jax.solver.batched import to_batch_last


def make_randomized_fleet(prob, defn, batch, dtype, seed=0):
    """Per-instance x0 / obstacle layout / goal reference params."""
    rng = np.random.default_rng(seed)
    params = prob.params

    cx0, cy0, r0 = defn.obstacles
    cx = jnp.asarray(cx0[:, None] + rng.uniform(-0.2, 0.2, (3, batch)), dtype)
    cy = jnp.asarray(cy0[:, None] + rng.uniform(-0.2, 0.2, (3, batch)), dtype)
    rr = jnp.asarray(r0[:, None] * rng.uniform(0.8, 1.1, (3, batch)), dtype)
    cons = list(params.constraints)
    ci = next(
        i for i, f in enumerate(prob.constraint_families)
        if f.constraint.structure[0] == "circle"
    )
    cons[ci] = dict(cons[ci], cx=cx, cy=cy, r=rr)

    xf = np.broadcast_to(defn.xf[:, None], (3, batch)).copy()
    xf[0] += rng.uniform(0.0, 0.3, batch)
    xf[1] += rng.uniform(0.0, 0.3, batch)
    xf[2] += rng.uniform(-0.3, 0.3, batch)
    xf = jnp.asarray(xf, dtype)
    gi = next(
        i for i, f in enumerate(prob.constraint_families)
        if f.constraint.structure[0] == "goal"
    )
    cons[gi] = dict(cons[gi], xf=xf)

    # the compiler merges stage+terminal quadratic costs into one stacked
    # family: re-derive q/c rows from the per-instance goal (lqr_cost form)
    cp0 = params.costs[0]
    Qstack = jnp.asarray(cp0["Q"], dtype)  # [N+1, 3, 3]
    q = -jnp.einsum("kij,jb->kib", Qstack, xf)
    c = 0.5 * jnp.einsum("ib,kij,jb->kb", xf, Qstack, xf)
    costs = (dict(cp0, q=q, c=c),)

    x0s = jnp.asarray(rng.uniform(-0.1, 0.1, (3, batch)), dtype)
    params = params.replace(
        x0=x0s, constraints=tuple(cons), costs=costs
    )
    Z0 = defn.initial_trajectory()
    Zb = to_batch_last(
        jax.tree_util.tree_map(
            lambda l: jnp.broadcast_to(l, (batch,) + l.shape), Z0
        )
    )
    return params, Zb, (np.asarray(cx), np.asarray(cy), np.asarray(rr)), np.asarray(xf)


def main() -> None:
    from altro_jax.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    batch = int(os.environ.get("BENCH_BATCH", "4096"))
    dtype = jnp.float32
    defn = UnicycleProblem(scenario="three_obstacles", dtype=dtype)
    prob = defn.make_problem(add_constraints=True).compile()
    params_b, Zb, (cx, cy, rr), xf = make_randomized_fleet(
        prob, defn, batch, dtype
    )
    baseline = 1000.0 / 31.768  # reference wall on its (fixed) 3-obstacle run

    # two modes: pure-f32 throughput, and "complete" — r5: the residue is
    # finished by the on-device fresh-restart CASCADE (penalty-ladder
    # variants, all f32, single dispatch) instead of the ~20x-slower
    # host-side f64 re-solve tail (r4: 114 solves/s in f64_complete mode)
    for mode, portfolio in (("f32_throughput", False), ("complete", True)):
        kw = {}
        if portfolio:
            kw = dict(
                restart_portfolio=(
                    dict(),
                    dict(penalty_scaling=4.0, max_iterations_outer=60,
                         max_iterations_total=900),
                    dict(penalty_scaling=2.0, max_iterations_outer=100,
                         max_iterations_total=1000),
                    dict(penalty_scaling=1.5, max_iterations_outer=150,
                         max_iterations_total=1600),
                ),
                restart_width=1024,
                restart_rounds=1,
                # structural infeasibility certificates (goal unreachably
                # deep inside an obstacle given v_max*h travel per step);
                # this sampler is feasible-by-construction, so the expected
                # INFEASIBLE count is 0 — the certificate guards solved%
                # against sampler drift
                detect_infeasible=True,
                infeasible_step_bound=float(defn.v_bnd * defn.tf / defn.N),
                # fail-fast: instances that will not converge under the
                # base ladder reach the cascade after ~120 iterations
                # instead of burning the full 300 (measured: +4% rate,
                # -0.1% solved)
                max_iterations_total=120,
            )
        # scenario config per the obstacle sweep (benchmark_obstacles.py):
        # reference-default 20-try search
        solver = bench.make_solver(
            prob, batch, initial_penalty=1.0,
            line_search_max_iterations=20, max_stall_iterations=10,
            outer_constraints_f64=True, **kw,
        )
        solver.f64_polish = False

        # the randomized fleet must run ON the kernels
        assert solver._p1._use_fwd(params_b, Zb), "forward kernel not engaged"
        assert solver._p1._use_kernel(
            solver._p1._bwd, params_b, Zb
        ), "fused backward kernel not engaged"
        sig = solver._p1._fwd.param_sig(params_b)
        assert len(sig) >= 6, sig  # circle cx/cy/r + goal xf + cost q/c

        res = solver.solve(params_b, Zb)
        jax.block_until_ready(res["Z"].U)
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            res = solver.solve(params_b, Zb)
            jax.block_until_ready(res["Z"].U)
            walls.append(time.perf_counter() - t0)
        dt = float(np.median(walls))

        hist = bench.status_histogram(np.asarray(res["status"]))
        iters = np.asarray(res["stats"].iterations_total)
        # per-instance obstacle clearance at every knot (the reference's
        # own quality check, `example_unicycle_test.cpp:76-83`: >= -1 mm),
        # against each instance's OWN randomized layout
        X = np.asarray(res["Z"].X, np.float64)  # [N+1, 3, B]
        d = (
            np.sqrt(
                (X[:, 0, None, :] - cx[None]) ** 2
                + (X[:, 1, None, :] - cy[None]) ** 2
            )
            - rr[None]
        )  # [N+1, 3, B]
        clearance_per_inst = d.min(axis=(0, 1))
        # terminal goal error against each instance's OWN randomized goal
        goal_err = np.abs(X[-1] - xf).max(axis=0)
        print(json.dumps({
            "metric": "randomized_unicycle_obstacle_fleet_solves_per_s_per_device",
            "mode": mode,
            "value": round(batch / dt, 2),
            "unit": "solves/s",
            "vs_baseline_fixed_scenario": round(batch / dt / baseline, 2),
            "batch": batch,
            "per_instance_param_leaves": sorted(sig),
            "status_hist": hist,
            "wall_s_per_batch": round(dt, 4),
            "wall_s_reps": [round(t, 4) for t in walls],
            "iters_p50": float(np.percentile(iters, 50)),
            "iters_p99": float(np.percentile(iters, 99)),
            "iters_max": int(iters.max()),
            "min_clearance_m": round(float(clearance_per_inst.min()), 5),
            "clearance_ok_pct": round(
                float((clearance_per_inst >= -1e-3).mean() * 100), 2
            ),
            "goal_err_p99": round(float(np.percentile(goal_err, 99)), 6),
            "f64_polish": solver.telemetry.get("polish"),
            "restart_portfolio": bool(portfolio),
            "device": str(jax.devices()[0]),
        }), flush=True)


if __name__ == "__main__":
    main()
