"""Larger model-zoo tests: quadrotor (n=13, m=4) and cartpole swing-up.

Shows the framework at dimensions beyond the reference's shipped examples
and on strongly nonlinear/underactuated dynamics.
"""
import jax
import jax.numpy as jnp
import numpy as np

from altro_jax import (
    ALSolver,
    ILQRSolver,
    Problem,
    SolverOptions,
    SolverStatus,
    control_bound,
    goal_constraint,
    initial_trajectory,
    lqr_cost,
)
from altro_jax.models.cartpole import cartpole_rk4
from altro_jax.models.quadrotor import (
    hover_controls,
    hover_state,
    quadrotor_rk4,
)


def test_quadrotor_waypoint():
    """Fly 2m sideways and 1m up from hover, control-bounded."""
    N, h = 60, 0.05
    model = quadrotor_rk4()
    x0 = hover_state((0.0, 0.0, 1.0))
    xf = hover_state((2.0, 0.0, 2.0))
    u_hover = hover_controls()

    Q = jnp.diag(jnp.concatenate([jnp.full(3, 1e-2), jnp.full(4, 1e-2),
                                  jnp.full(3, 1e-2), jnp.full(3, 1e-2)])) * h
    R = jnp.eye(4) * 1e-2 * h
    Qf = jnp.eye(13) * 100.0

    prob = Problem(N)
    prob.set_dynamics(model, range(N))
    prob.set_cost(lqr_cost(Q, R, xf, u_hover), range(N))
    prob.set_cost(lqr_cost(Qf, jnp.zeros((4, 4)), xf, terminal=True), N)
    prob.set_constraint(control_bound([0.0] * 4, [4.0] * 4), range(N))
    prob.set_initial_state(x0)
    cp = prob.compile()

    solver = ALSolver(cp, SolverOptions())
    Z0 = initial_trajectory(13, 4, N, h, u0=u_hover, )
    res = solver.solve(cp.params, Z0)
    assert int(res.status) == SolverStatus.SOLVED
    X = np.asarray(res.Z.X)
    assert np.abs(X[-1, :3] - np.array([2.0, 0.0, 2.0])).max() < 0.05
    # quaternion stays near unit norm through integration
    qn = np.linalg.norm(X[:, 3:7], axis=1)
    assert np.abs(qn - 1.0).max() < 0.02
    U = np.asarray(res.Z.U)
    assert U.min() >= -1e-4 and U.max() <= 4.0 + 1e-4


def test_cartpole_swingup():
    """Classic swing-up to the unstable equilibrium with bounded force."""
    N, h = 100, 0.05
    model = cartpole_rk4()
    xf = jnp.array([0.0, jnp.pi, 0.0, 0.0])
    Q = jnp.eye(4) * 0.01 * h
    R = jnp.eye(1) * 0.01 * h
    Qf = jnp.diag(jnp.array([100.0, 500.0, 100.0, 100.0]))

    prob = Problem(N)
    prob.set_dynamics(model, range(N))
    prob.set_cost(lqr_cost(Q, R, xf), range(N))
    prob.set_cost(lqr_cost(Qf, jnp.zeros((1, 1)), xf, terminal=True), N)
    prob.set_constraint(goal_constraint(xf), N)
    prob.set_constraint(control_bound([-15.0], [15.0]), range(N))
    prob.set_initial_state(jnp.zeros(4))
    cp = prob.compile()

    opts = SolverOptions(max_iterations_inner=400, max_iterations_total=1200)
    solver = ALSolver(cp, opts)
    # sinusoidal excitation seed — swing-up needs energy in the initial guess
    Z0 = initial_trajectory(4, 1, N, h)
    Z0 = Z0.replace(U=2.0 * jnp.sin(2 * jnp.pi * jnp.arange(N) / N * 2.0)[:, None])
    res = solver.solve(cp.params, Z0)
    X = np.asarray(res.Z.X)
    assert int(res.status) == SolverStatus.SOLVED
    np.testing.assert_allclose(X[-1], np.asarray(xf), atol=1e-3)
    assert np.abs(np.asarray(res.Z.U)).max() <= 15.0 + 1e-3
