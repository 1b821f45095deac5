"""Generality tests: nonlinear costs, per-knot parameters, heterogeneous
dynamics families.

The reference supports arbitrary user costs/dynamics via virtual classes
with hand-written derivatives (`functionbase.hpp:53-87`); here arbitrary
pure functions get AD expansions.  These paths aren't exercised by the
canned (quadratic, single-model) benchmarks, so they get their own tests.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from altro_jax import (
    ALSolver,
    Cost,
    ILQRSolver,
    Problem,
    SolverOptions,
    SolverStatus,
    discretize,
    goal_constraint,
    initial_trajectory,
    lqr_cost,
)
from altro_jax.models.triple_integrator import triple_integrator_rk4
from altro_jax.models.unicycle import unicycle, unicycle_rk4


def test_nonlinear_cost_ad_expansion_solve():
    """Custom smooth non-quadratic cost through the AD expansion path."""
    N, n, m, h = 40, 3, 2, 0.05
    xf = jnp.array([1.0, 0.5, 0.0])

    def stage_fn(params, x, u):
        err = x - params["xf"]
        # non-quadratic: quartic position terms + cosh control penalty
        return 0.01 * jnp.sum(err**2 + 0.5 * err**4) + 0.01 * jnp.sum(
            jnp.cosh(u) - 1.0
        )

    stage = Cost(params={"xf": xf}, fn=stage_fn, name="quartic")
    term = lqr_cost(jnp.eye(3) * 50.0, jnp.zeros((2, 2)), xf, terminal=True)

    prob = Problem(N)
    prob.set_dynamics(unicycle_rk4(), range(N))
    prob.set_cost(stage, range(N))
    prob.set_cost(term, N)
    prob.set_initial_state(jnp.zeros(3))
    cp = prob.compile()

    solver = ILQRSolver(cp, SolverOptions())
    Z0 = initial_trajectory(n, m, N, h, u0=[0.1, 0.0])
    res = solver.solve(cp.params, (), Z0)
    assert int(res.status) == SolverStatus.SOLVED
    assert np.abs(np.asarray(res.Z.X[-1]) - np.asarray(xf)).max() < 0.1


def test_per_knot_cost_params_tracking():
    """Time-varying reference: distinct LQR costs per knot stack their
    params (the _group stacked-params path)."""
    N, n, m, h = 30, 3, 2, 0.1
    # reference trajectory: straight line in x
    xrefs = [jnp.array([0.05 * k, 0.0, 0.0]) for k in range(N + 1)]
    prob = Problem(N)
    prob.set_dynamics(unicycle_rk4(), range(N))
    for k in range(N):
        prob.set_cost(lqr_cost(jnp.eye(3) * 1.0, jnp.eye(2) * 0.1, xrefs[k]), k)
    prob.set_cost(
        lqr_cost(jnp.eye(3) * 100.0, jnp.zeros((2, 2)), xrefs[N], terminal=True), N
    )
    prob.set_initial_state(jnp.zeros(3))
    cp = prob.compile()
    # one stage family with stacked params + terminal family
    stage_fams = [f for f in cp.cost_families if len(f.knots) > 1]
    assert len(stage_fams) == 1 and not stage_fams[0].shared

    solver = ILQRSolver(cp, SolverOptions())
    res = solver.solve(cp.params, (), initial_trajectory(n, m, N, h, u0=[0.1, 0.0]))
    assert int(res.status) == SolverStatus.SOLVED
    X = np.asarray(res.Z.X)
    # tracks the moving reference: x-position increases roughly linearly
    assert X[-1, 0] > 1.0
    assert np.abs(X[:, 1]).max() < 0.15  # stays near y=0


def test_heterogeneous_dynamics_families():
    """Two different models over the horizon (hybrid/switched systems,
    the lax.switch dispatch path in CompiledProblem.dynamics_step)."""
    N, h = 20, 0.1
    tri = triple_integrator_rk4(dof=1)  # n=3, m=1
    # a second family: same dims, damped dynamics
    from altro_jax import ContinuousModel

    def damped_fn(params, x, u, t):
        return jnp.concatenate([x[1:2], x[2:3] - params["c"] * x[1:2], u])

    damped = discretize(
        ContinuousModel(params={"c": jnp.asarray(0.5)}, fn=damped_fn, n=3, m=1),
        "rk4",
    )
    prob = Problem(N)
    prob.set_dynamics(tri, range(N // 2))
    prob.set_dynamics(damped, range(N // 2, N))
    xf = jnp.array([1.0, 0.0, 0.0])
    prob.set_cost(lqr_cost(jnp.eye(3), jnp.eye(1) * 0.01, xf), range(N))
    prob.set_cost(lqr_cost(jnp.eye(3) * 1e4, jnp.zeros((1, 1)), xf, terminal=True), N)
    prob.set_constraint(goal_constraint(xf), N)
    prob.set_initial_state(jnp.array([-1.0, 0.0, 0.0]))
    cp = prob.compile()
    assert len(cp.dynamics_families) == 2

    solver = ALSolver(cp, SolverOptions())
    res = solver.solve(cp.params, initial_trajectory(3, 1, N, h))
    assert int(res.status) == SolverStatus.SOLVED
    np.testing.assert_allclose(np.asarray(res.Z.X[-1]), xf, atol=1e-3)
    # rollout consistency: states actually follow the per-segment dynamics
    Zr = solver.ilqr.rollout(cp.params, res.Z)
    np.testing.assert_allclose(Zr.X, res.Z.X, atol=1e-10)
