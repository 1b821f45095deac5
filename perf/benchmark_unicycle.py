#!/usr/bin/env python
"""Unicycle AL solve benchmark with profiler output.

Analog of `perf/benchmark_unicycle.cpp` + `perf/profiler_unicycle.out`:
times single constrained solves (turn-90 and three-obstacle scenarios) and
writes a phase-breakdown profile.  Run with `cpu` for host-only f64.
"""
import sys

import jax

if "cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp

from altro_jax import ALSolver, SolverOptions
from altro_jax.models.problems import UnicycleProblem
from altro_jax.utils.benchmarking import benchmark
from altro_jax.utils.timer import Timer


def run(scenario: str, timer: Timer):
    defn = UnicycleProblem(scenario=scenario)
    prob = defn.make_problem(add_constraints=True).compile()
    solver = ALSolver(prob, SolverOptions(constraint_tolerance=1e-6))
    Z0 = defn.initial_trajectory()
    solve = jax.jit(solver.solve)

    with timer.scope(f"{scenario}/compile", block=True):
        res = solve(prob.params, Z0)
        jax.block_until_ready(res.Z.U)
    with timer.scope(f"{scenario}/solve", block=True):
        res = solve(prob.params, Z0)
        jax.block_until_ready(res.Z.U)
    bench = benchmark(lambda: solve(prob.params, Z0).Z.U, samples=20)
    print(
        f"{scenario}: {bench.median:.3f} ms median single solve "
        f"({int(res.stats.iterations_total)} iterations, "
        f"status {int(res.status)})"
    )
    return bench


def main():
    timer = Timer(active=True)
    run("turn90", timer)
    run("three_obstacles", timer)
    print()
    timer.print_summary()
    # Reference anchor: altro-cpp solves the three-obstacle problem in
    # 31.768 ms single-core (perf/profiler_unicycle.out:3).


if __name__ == "__main__":
    main()
