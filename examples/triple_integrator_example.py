#!/usr/bin/env python
"""Triple-integrator solves (analog of `examples/triple_integrator.cpp`)."""
import sys

import jax

if "cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

import numpy as np

from altro_jax import ALSolver, ILQRSolver, SolverOptions, SolverStatus
from altro_jax.models.problems import TripleIntegratorProblem


def main():
    defn = TripleIntegratorProblem(dof=2)
    # unconstrained
    prob = defn.make_problem(add_constraints=False).compile()
    solver = ILQRSolver(prob, SolverOptions())
    res = solver.solve(prob.params, (), defn.initial_trajectory())
    print(f"unconstrained: {SolverStatus(int(res.status)).name} in "
          f"{int(res.stats.iterations_inner)} iterations")
    # constrained (control bounds + goal)
    probc = defn.make_problem(add_constraints=True).compile()
    alsolver = ALSolver(probc, SolverOptions())
    resc = alsolver.solve(probc.params, defn.initial_trajectory())
    print(f"constrained:   {SolverStatus(int(resc.status)).name} in "
          f"{int(resc.stats.iterations_total)} iterations, "
          f"goal error {np.abs(np.asarray(resc.Z.X[-1]) - defn.xf).max():.2e}, "
          f"u0 saturates at {np.asarray(resc.Z.U[0])}")


if __name__ == "__main__":
    main()
