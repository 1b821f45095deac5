"""Core data types: trajectories, solver status, statistics.

Struct-of-arrays replaces the reference's object-per-knot design: a
trajectory is stacked `X:[N+1,n], U:[N,m], t:[N+1], h:[N]` tensors instead of
a `Trajectory<n,m>` of `KnotPoint` objects (`altro/common/trajectory.hpp:25`,
`knotpoint.hpp:32`), so every per-knot computation becomes one batched XLA op.
"""
from __future__ import annotations

import enum

import jax
import jax.numpy as jnp

from ._pytree import pytree_dataclass, static_field


class SolverStatus(enum.IntEnum):
    """Solver termination codes (`altro/common/solver_stats.hpp:20-31`)."""

    SOLVED = 0
    UNSOLVED = 1
    STATE_LIMIT = 2
    CONTROL_LIMIT = 3
    COST_INCREASE = 4
    MAX_ITERATIONS = 5
    MAX_OUTER_ITERATIONS = 6
    MAX_INNER_ITERATIONS = 7
    MAX_PENALTY = 8
    BACKWARD_PASS_REGULARIZATION_FAILED = 9
    # Extension beyond the reference's 10 codes: the inner solve exited
    # via the numerical-floor stall heuristic (SolverOptions.
    # max_stall_iterations) — the cost stopped moving at working precision
    # but the gradient tolerance was never met.  Distinct from SOLVED so
    # downstream "solved" checks don't silently absorb non-convergence;
    # constraint satisfaction is still checked by the AL outer loop.
    SOLVED_STALLED = 10
    # Extension (r5): the instance's constraints are PROVABLY mutually
    # unsatisfiable (e.g. an equality goal strictly inside an obstacle
    # disc that is constrained at the same knot — see
    # `problem/infeasibility.py`).  Reported instead of burning the full
    # iteration budget to MAX_PENALTY, so fleet "solved%" measures the
    # solver, not the scenario sampler.  One step past the reference's
    # constraint introspection (`al_solver.hpp:68-104`).
    INFEASIBLE = 11


@pytree_dataclass
class Trajectory:
    """State/control trajectory with knot-point times.

    X: [N+1, n] states. U: [N, m] controls. t: [N+1] times. h: [N] steps.

    The reference stores a control at the terminal knot too but never uses it
    in any shipped problem (terminal costs are built with R=0,
    `examples/problems/unicycle.cpp:70-71`); we store exactly N controls and
    substitute zeros where a terminal (x,u) signature is required.
    """

    X: jax.Array
    U: jax.Array
    t: jax.Array
    h: jax.Array

    @property
    def N(self) -> int:
        """Number of segments (knot points minus one)."""
        return self.U.shape[-2]

    @property
    def n(self) -> int:
        return self.X.shape[-1]

    @property
    def m(self) -> int:
        return self.U.shape[-1]

    def upad(self) -> jax.Array:
        """Controls padded with a zero terminal row → [N+1, m]."""
        zrow = jnp.zeros(self.U.shape[:-2] + (1, self.m), self.U.dtype)
        return jnp.concatenate([self.U, zrow], axis=-2)


def initial_trajectory(
    n: int,
    m: int,
    N: int,
    h: float,
    u0=None,
    x0=None,
    dtype=jnp.float64,
) -> Trajectory:
    """Build a uniform-step initial trajectory.

    Mirrors `Trajectory::SetUniformStep` (`trajectory.hpp:122-130`) plus the
    constant-control initialization the canned problems use
    (`examples/problems/unicycle.hpp:88-96`).
    """
    dtype = jnp.result_type(dtype)
    X = jnp.zeros((N + 1, n), dtype)
    if x0 is not None:
        X = X + jnp.asarray(x0, dtype)[None, :]
    U = jnp.zeros((N, m), dtype)
    if u0 is not None:
        U = U + jnp.asarray(u0, dtype)[None, :]
    t = jnp.arange(N + 1, dtype=dtype) * h
    hs = jnp.full((N,), h, dtype)
    return Trajectory(X=X, U=U, t=t, h=hs)


@pytree_dataclass
class SolverStats:
    """Per-iteration solve statistics (`altro/common/solver_stats.hpp:44-203`).

    Fixed-capacity arrays with a row pointer replace the reference's growing
    std::vectors.  `log_*` writes the current row; `new_iteration` advances
    the pointer, carrying the previous row forward exactly like
    `SolverStats::NewIteration` (`solver_stats.cpp:54-66`) so the
    convergence logic can read "last logged" values.
    """

    iterations_inner: jax.Array
    iterations_outer: jax.Array
    iterations_total: jax.Array
    initial_cost: jax.Array
    # current-row scalars (what `.back()` reads in the reference)
    cost: jax.Array
    alpha: jax.Array
    improvement_ratio: jax.Array
    gradient: jax.Array
    cost_decrease: jax.Array
    regularization: jax.Array
    violations: jax.Array
    max_penalty: jax.Array
    # history rows
    rows: jax.Array  # [capacity, 8] columns in _COLUMNS order
    length: jax.Array


_COLUMNS = (
    "cost",
    "alpha",
    "improvement_ratio",
    "gradient",
    "cost_decrease",
    "regularization",
    "violations",
    "max_penalty",
)


def stats_init(capacity: int, dtype=jnp.float64) -> SolverStats:
    dtype = jnp.result_type(dtype)
    z = jnp.zeros((), dtype)
    i0 = jnp.zeros((), jnp.int32)
    return SolverStats(
        iterations_inner=i0,
        iterations_outer=i0,
        iterations_total=i0,
        initial_cost=z,
        cost=z,
        alpha=z,
        improvement_ratio=z,
        gradient=z,
        cost_decrease=z,
        regularization=z,
        violations=z,
        max_penalty=z,
        rows=jnp.zeros((capacity, len(_COLUMNS)), dtype),
        length=i0,
    )


def stats_log(stats: SolverStats, **values) -> SolverStats:
    """Log values into the current row (overwrites, like `SolverStats::Log`)."""
    updates = dict(values)
    row = stats.rows[stats.length]
    cur = {name: getattr(stats, name) for name in _COLUMNS}
    cur.update({k: jnp.asarray(v, stats.rows.dtype) for k, v in updates.items()})
    row = jnp.stack([cur[name] for name in _COLUMNS])
    rows = stats.rows.at[stats.length].set(row)
    return stats.replace(rows=rows, **{k: cur[k] for k in updates})


def stats_new_iteration(stats: SolverStats) -> SolverStats:
    """Advance the row pointer; current scalars carry forward
    (`solver_stats.cpp:54-66`)."""
    length = jnp.minimum(stats.length + 1, stats.rows.shape[0] - 1)
    row = jnp.stack([getattr(stats, name) for name in _COLUMNS])
    rows = stats.rows.at[length].set(row)
    return stats.replace(rows=rows, length=length)


def stats_column(stats: SolverStats, name: str) -> jax.Array:
    """Full history column for `name` (valid up to `stats.length`)."""
    return stats.rows[:, _COLUMNS.index(name)]
