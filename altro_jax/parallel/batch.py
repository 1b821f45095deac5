"""Batched multi-scenario solves via vmap.

The real win over the reference: altro-cpp solves one problem per call
and parallelizes only the per-knot expansions over a thread pool
(`altro/common/threadpool.hpp:45`, `ilqr/ilqr.hpp:350-366`).  Here the whole
AL-iLQR solve is a pure function, so `jax.vmap` lifts it to thousands of
scenarios (initial states, goals, obstacle layouts) as one XLA program;
JAX's while-loop batching masks converged instances automatically.
"""
from __future__ import annotations

from typing import Any, Optional

import jax
import jax.numpy as jnp

from ..options import SolverOptions
from ..problem.problem import CompiledProblem, ProblemParams
from ..solver.al import ALSolver
from ..types import Trajectory


def params_axes(x0=0, dynamics=None, costs=None, constraints=None) -> ProblemParams:
    """Build a ProblemParams of vmap in_axes (pytree-prefix form).

    Defaults to batching only the initial state.  To batch e.g. cost
    references or obstacle positions, pass an axes pytree (or int) for the
    corresponding entry.
    """
    return ProblemParams(
        x0=x0, dynamics=dynamics, costs=costs, constraints=constraints
    )


class BatchedALSolver:
    """vmap-lifted AL-iLQR over a batch of problem instances.

    ``in_axes`` selects which problem parameters vary across the batch
    (default: initial state only).  The trajectory guess is always batched.
    """

    def __init__(
        self,
        prob: CompiledProblem,
        opts: SolverOptions = None,
        in_axes: ProblemParams = None,
    ):
        self.solver = ALSolver(prob, opts)
        self.prob = prob
        if in_axes is None:
            in_axes = params_axes(x0=0)
        self.in_axes = in_axes
        self._solve = jax.jit(
            jax.vmap(self.solver.solve, in_axes=(in_axes, 0, None))
        )
        self._solve_warm = jax.jit(
            jax.vmap(self.solver.solve, in_axes=(in_axes, 0, 0))
        )

    def solve(self, params: ProblemParams, Z: Trajectory, al=None):
        """Solve a batch. `params` leaves selected by in_axes carry a leading
        batch dim; `Z` is batched; `al` optionally warm-starts (batched)."""
        if al is None:
            return self._solve(params, Z, None)
        return self._solve_warm(params, Z, al)
