#!/usr/bin/env python
"""Unicycle turn-90 parking solve (analog of `examples/unicycle.cpp`).

Solves the constrained parking problem (goal + control bounds) and prints
the iteration table and solution summary.
"""
import sys

import jax

if "cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

import numpy as np

from altro_jax import ALSolver, LogLevel, SolverOptions, SolverStatus
from altro_jax.models.problems import UnicycleProblem


def main():
    defn = UnicycleProblem()
    prob = defn.make_problem(add_constraints=True).compile()
    opts = SolverOptions(constraint_tolerance=1e-6, verbose=LogLevel.INNER)
    solver = ALSolver(prob, opts)
    res = solver.solve(prob.params, defn.initial_trajectory())
    print(f"status:     {SolverStatus(int(res.status)).name}")
    print(f"iterations: {int(res.stats.iterations_total)} total / "
          f"{int(res.stats.iterations_outer)} outer")
    J = solver.fns.total_cost(prob.params, res.al, res.Z)
    print(f"final cost: {float(J):.12g}")
    print(f"violation:  {float(res.stats.violations):.3e}")
    print(f"final state: {np.asarray(res.Z.X[-1])}  (goal {defn.xf})")


if __name__ == "__main__":
    main()
