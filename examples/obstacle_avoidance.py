#!/usr/bin/env python
"""Unicycle three-obstacle avoidance (analog of `examples/obstacle_constraints.cpp`).

Solves the kThreeObstacles scenario and prints obstacle clearances.
"""
import sys

import jax

if "cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

import numpy as np

from altro_jax import ALSolver, SolverOptions, SolverStatus
from altro_jax.models.problems import UnicycleProblem


def main():
    defn = UnicycleProblem(scenario="three_obstacles")
    prob = defn.make_problem(add_constraints=True).compile()
    solver = ALSolver(prob, SolverOptions(initial_penalty=10.0))
    res = solver.solve(prob.params, defn.initial_trajectory())
    print(f"status: {SolverStatus(int(res.status)).name}, "
          f"{int(res.stats.iterations_total)} iterations")
    X = np.asarray(res.Z.X)
    cx, cy, cr = defn.obstacles
    for i in range(len(cx)):
        d = np.sqrt((X[:, 0] - cx[i]) ** 2 + (X[:, 1] - cy[i]) ** 2) - cr[i]
        print(f"obstacle {i}: min clearance {d.min():+.4f} m")
    print(f"goal error: {np.abs(X[-1] - defn.xf).max():.2e}")


if __name__ == "__main__":
    main()
