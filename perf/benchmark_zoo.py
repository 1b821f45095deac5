#!/usr/bin/env python
"""On-device model-zoo validation: quadrotor (n=13) and cartpole (n=4)
through the batch-native solver and the Pallas kernels on a GPU (the
quadrotor's backward pass runs on the scan path: its state is wider than
the fused backward kernel takes).

The reference's dynamics layer is dimension-generic
(altro-cpp's `altro/problem/dynamics.hpp:59-187`); the parking benchmark
only exercises the kernels at the unicycle's n=3, m=2.  Here:

  * kernel-vs-scan solve check: the fused-kernel solve and the XLA-scan
    solve must reach the same solved rate and matching costs at n=13 and
    n=4 before timing;
  * throughput + status histogram for a perturbed fleet of each model.

Vector dynamics-param leaves (the quadrotor's inertia [3]) are read as
per-element scalars inside the kernels (`ops/lanes.py`).

Run on the GPU host: python perf/benchmark_zoo.py
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
from altro_jax import (
    Problem,
    SolverStatus,
    control_bound,
    goal_constraint,
    lqr_cost,
)
from altro_jax.models.cartpole import cartpole_rk4
from altro_jax.models.problems import QuadrotorProblem
from altro_jax.solver.batched import ALSolverBatched, to_batch_last
from altro_jax.types import initial_trajectory


def build_quadrotor():
    defn = QuadrotorProblem()
    cp = defn.make_problem(add_constraints=True).compile()
    return cp, defn.initial_trajectory(), defn.x0, defn.xf


def build_cartpole(N=60, tf=2.0):
    n, m = 4, 1
    h = tf / N
    xf = jnp.array([0.0, np.pi, 0.0, 0.0], jnp.float32)
    prob = Problem(N=N)
    prob.set_initial_state(jnp.zeros(n, jnp.float32))
    prob.set_dynamics(cartpole_rk4(), range(N))
    prob.set_cost(
        lqr_cost(jnp.eye(n) * 1e-2 * h, jnp.eye(m) * 1e-1 * h, xf,
                 jnp.zeros(m)),
        range(N),
    )
    prob.set_cost(
        lqr_cost(jnp.eye(n) * 100.0, jnp.zeros((m, m)), xf, jnp.zeros(m),
                 terminal=True),
        N,
    )
    prob.set_constraint(control_bound(lb=[-10.0], ub=[10.0]), range(N))
    cp = prob.compile()
    Z0 = initial_trajectory(n, m, N, h, u0=jnp.full((m,), 0.01), dtype=jnp.float32)
    return cp, Z0, np.zeros(n, np.float32), np.asarray(xf)


def main() -> None:
    from altro_jax.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    batch = int(os.environ.get("BENCH_BATCH", "2048"))
    rng = np.random.default_rng(0)
    for name, (cp, Z0, x0, xf), spread in (
        ("quadrotor", build_quadrotor(), 0.05),
        ("cartpole", build_cartpole(), 0.05),
    ):
        n, m, N = cp.n, cp.m, cp.N
        opts = bench.bench_options().replace(
            initial_penalty=1.0, line_search_max_iterations=20,
            max_stall_iterations=10, outer_constraints_f64=True,
        )
        s = ALSolverBatched(cp, opts)
        # the quadrotor's state is wider than the fused backward kernel
        # takes (`BackwardFusedKernel.max_state_dim`): its backward pass
        # runs expand + riccati_scan
        assert s._fwd is not None, f"{name}: forward kernel ineligible"
        x0s = jnp.asarray(
            x0[:, None] + spread * rng.standard_normal((n, batch)),
            jnp.float32,
        )
        params = cp.params.replace(x0=x0s)
        Zb = to_batch_last(
            jax.tree_util.tree_map(
                lambda l: jnp.broadcast_to(l, (batch,) + l.shape), Z0
            )
        )

        # ---- compiled kernel-vs-oracle cross-check ON THIS DEVICE.  At
        # n=13 the pre-regularization cost-to-go explodes (P ~ 1e9 on the
        # open-loop hover rollout before the retry loop damps it), so a
        # raw single-sweep comparison is chaotic in f32 — the meaningful
        # correctness statement is FULL-SOLVE equivalence: the fused-
        # kernel solve and the XLA-scan solve must reach the same
        # statuses (>= 99% of lanes; borderline instances may flip at
        # f32) and matching endpoints on jointly-solved lanes.
        s_scan = ALSolverBatched(
            cp, opts.replace(backward_pass="scan", forward_pass="scan")
        )
        r_k = jax.jit(s.solve)(params, Zb)
        r_s = jax.jit(s_scan.solve)(params, Zb)
        st_k = np.asarray(r_k["status"])
        st_s = np.asarray(r_s["status"])
        # chaotic nonconvex fleets (cartpole swing-up) legitimately flip
        # WHICH borderline instances solve between two f32 paths; the
        # path-equivalence contract is the SOLVED RATE (±2%) plus matching
        # costs for the jointly solved instances
        rate_k = float((st_k == int(SolverStatus.SOLVED)).mean())
        rate_s = float((st_s == int(SolverStatus.SOLVED)).mean())
        assert abs(rate_k - rate_s) <= 0.02, (name, rate_k, rate_s)
        agree = float((st_k == st_s).mean())
        both = (st_k == int(SolverStatus.SOLVED)) & (
            st_s == int(SolverStatus.SOLVED)
        )
        # raw trajectory cost per instance (zero AL state): a nonconvex
        # problem at the solver's tolerances admits distinct local optima
        # per path, so the contract is distributional — same cost for the
        # typical instance, bounded spread in the tail
        al0 = s.al_state_init(batch, jnp.float32)
        Jk = np.asarray(jax.jit(s.total_cost)(params, al0, r_k["Z"]))
        Js = np.asarray(jax.jit(s.total_cost)(params, al0, r_s["Z"]))
        relj = np.abs(Jk - Js)[both] / np.maximum(np.abs(Js)[both], 1e-9)
        assert float(np.median(relj)) < 2e-2, (name, float(np.median(relj)))
        errs = {
            "status_agreement": agree,
            "solved_cost_rel_diff_p50": float(f"{np.median(relj):.3g}"),
            "solved_cost_rel_diff_p99": float(
                f"{np.percentile(relj, 99):.3g}"
            ),
        }

        # ---- fleet throughput: the shipped compacted pipeline with the
        # fresh-restart cascade (same configuration family as the
        # obstacle/randomized benchmarks)
        solver = bench.make_solver(
            cp, batch, initial_penalty=1.0,
            line_search_max_iterations=20, max_stall_iterations=10,
            outer_constraints_f64=True, f64_polish=False,
            restart_portfolio=(
                dict(),
                dict(penalty_scaling=4.0, max_iterations_outer=60,
                     max_iterations_total=900),
                dict(penalty_scaling=1.5, max_iterations_outer=120,
                     max_iterations_total=1100),
            ),
            restart_width=min(1024, batch),
        )
        res = solver.solve(params, Zb)
        jax.block_until_ready(res["status"])
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            res = solver.solve(params, Zb)
            jax.block_until_ready(res["status"])
            walls.append(time.perf_counter() - t0)
        dt = float(np.median(walls))
        hist = bench.status_histogram(np.asarray(res["status"]))
        iters = np.asarray(res["stats"].iterations_total)
        Xs = np.asarray(res["Z"].X, np.float64)
        term_err = float(
            np.median(np.abs(Xs[-1] - np.asarray(xf, np.float64)[:, None]).max(axis=0))
        )
        print(json.dumps({
            "metric": f"{name}_al_ilqr_solves_per_s_per_device",
            "value": round(batch / dt, 2),
            "unit": "solves/s",
            "n": n, "m": m, "N": N,
            "batch": batch,
            "status_hist": hist,
            "wall_s_per_batch": round(dt, 4),
            "wall_s_reps": [round(t, 4) for t in walls],
            "iters_p50": float(np.percentile(iters, 50)),
            "iters_p99": float(np.percentile(iters, 99)),
            "kernel_vs_scan_solve_check": errs,
            "median_terminal_err": round(term_err, 6),
            "fused_backward_kernel": s._bwd is not None,
            "device": jax.devices()[0].device_kind,
        }), flush=True)


if __name__ == "__main__":
    main()
