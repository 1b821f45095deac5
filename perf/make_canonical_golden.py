#!/usr/bin/env python
"""Generate the f64 reference-solution goldens for the canonical bench element.

The driver's parity metric is "control trajectories matching altro-cpp to
1e-4" (BASELINE.md:28).  The per-instance f64 solver IS the
altro-cpp-equivalent program: its full-solve trajectory/cost/iteration
behavior is pinned against the reference's Altro.jl-derived goldens in
tests/test_al.py (J to 1e-9, 14/5 iterations, `auglag_test.cpp:325-351`).

Two goldens are produced for the canonical bench element (unicycle turn-90
parking, N=100, goal + control bounds, x0 = 0):

  * `unicycle_turn90_refsolve_f64_tol6.npz` — the reference's TEST config
    (`constraint_tolerance = 1e-6`, `auglag_test.cpp:337`).  This solve
    reproduces the reference's pinned J = 0.03893465058924039 to 1e-11 and
    its exact 14/5 iteration counts; it is the parity anchor `bench.py`
    measures `control_parity` against.
  * `unicycle_turn90_refsolve_f64.npz` — reference-DEFAULT options (the
    config of the reference's own benchmark, `perf/benchmark_unicycle.cpp`);
    used for the bench's `control_parity_bench_tol` stopping-ball report.

Run on CPU with x64: `python perf/make_canonical_golden.py`.
"""
import os
import sys

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)


def solve_and_save(opts_kw: dict, fname: str) -> None:
    import jax
    import jax.numpy as jnp

    from altro_jax import ALSolver, SolverOptions, SolverStatus
    from altro_jax.models.problems import UnicycleProblem

    defn = UnicycleProblem(dtype=jnp.float64)
    prob = defn.make_problem(add_constraints=True).compile()
    solver = ALSolver(prob, SolverOptions(**opts_kw))
    res = jax.jit(solver.solve)(prob.params, defn.initial_trajectory())
    status = int(res.status)
    assert status == int(SolverStatus.SOLVED), status
    out = os.path.join(_REPO, "tests", "goldens", fname)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    np.savez(
        out,
        X=np.asarray(res.Z.X, np.float64),
        U=np.asarray(res.Z.U, np.float64),
        cost=np.asarray(res.stats.cost, np.float64),
        violations=np.asarray(res.stats.violations, np.float64),
        iterations_total=np.asarray(res.stats.iterations_total),
        iterations_outer=np.asarray(res.stats.iterations_outer),
    )
    print(
        f"wrote {fname}: J={float(res.stats.cost):.12f} "
        f"viol={float(res.stats.violations):.3e} "
        f"iters={int(res.stats.iterations_total)}"
        f"/{int(res.stats.iterations_outer)} outer"
    )


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    solve_and_save(dict(constraint_tolerance=1e-6), "unicycle_turn90_refsolve_f64_tol6.npz")
    solve_and_save(dict(), "unicycle_turn90_refsolve_f64.npz")


if __name__ == "__main__":
    sys.exit(main())
