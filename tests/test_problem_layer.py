"""Problem-layer tests: dynamics, integrators, costs, constraints.

Mirrors the reference's derivative checks and hardcoded-value tests
(`test/problem/*`, `test/ilqr/ilqr_test.cpp:131-181`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from altro_jax import (
    control_bound,
    goal_constraint,
    circle_constraint,
    lqr_cost,
    quadratic_cost,
    discretize,
)
from altro_jax.models.triple_integrator import triple_integrator, triple_integrator_rk4
from altro_jax.models.unicycle import unicycle, unicycle_rk4
from altro_jax.utils.derivative_check import finite_diff_jacobian


def test_unicycle_dynamics_and_jacobian():
    model = unicycle()
    x = jnp.array([0.1, 0.2, jnp.pi / 3])
    u = jnp.array([0.5, -0.3])
    xdot = model(x, u, 0.0)
    # examples/unicycle.cpp:12-21
    np.testing.assert_allclose(
        xdot, [0.5 * np.cos(np.pi / 3), 0.5 * np.sin(np.pi / 3), -0.3], atol=1e-12
    )
    # AD Jacobian vs finite differences (test/problem/unicycle_test.cpp:38-50)
    A, B = jax.jacfwd(model.fn, argnums=(1, 2))(None, x, u, 0.0)
    Afd, Bfd = finite_diff_jacobian(lambda x_, u_: model.fn(None, x_, u_, 0.0), x, u)
    np.testing.assert_allclose(A, Afd, atol=1e-6)
    np.testing.assert_allclose(B, Bfd, atol=1e-6)


def test_rk4_discrete_jacobian_matches_reference_goldens():
    """Hardcoded discrete A,B for the triple integrator (dof=2, h=0.1) from
    `test/ilqr/ilqr_test.cpp:159-174`."""
    model = triple_integrator_rk4(dof=2)
    x = jnp.zeros(6)
    u = jnp.zeros(2)
    A, B = model.jacobian(x, u, 0.0, 0.1)
    A_exp = np.array(
        [
            [1, 0, 0.1, 0, 0.005, 0],
            [0, 1, 0, 0.1, 0, 0.005],
            [0, 0, 1, 0, 0.1, 0],
            [0, 0, 0, 1, 0, 0.1],
            [0, 0, 0, 0, 1, 0],
            [0, 0, 0, 0, 0, 1],
        ]
    )
    B_exp = np.array(
        [
            [1 / 6e3, 0],
            [0, 1 / 6e3],
            [5e-3, 0],
            [0, 5e-3],
            [0.1, 0],
            [0, 0.1],
        ]
    )
    np.testing.assert_allclose(A, A_exp, atol=1e-6)
    np.testing.assert_allclose(B, B_exp, atol=1e-6)


def test_rk4_euler_integration_values():
    model = triple_integrator(dof=1)
    x = jnp.array([1.0, 2.0, 3.0])
    u = jnp.array([4.0])
    h = 0.1
    rk4 = discretize(model, "rk4")
    euler = discretize(model, "euler")
    np.testing.assert_allclose(euler(x, u, 0.0, h), x + h * jnp.array([2.0, 3.0, 4.0]))
    # RK4 on a linear system == truncated matrix exponential (exact here
    # through h^3 terms of this nilpotent system)
    xn = rk4(x, u, 0.0, h)
    expect = np.array(
        [
            1.0 + 2.0 * h + 3.0 * h**2 / 2 + 4.0 * h**3 / 6,
            2.0 + 3.0 * h + 4.0 * h**2 / 2,
            3.0 + 4.0 * h,
        ]
    )
    np.testing.assert_allclose(xn, expect, atol=1e-12)


def test_quadratic_cost_expansion():
    """Cost expansion equals Q, R for an LQR cost
    (`test/ilqr/ilqr_test.cpp:131-154`)."""
    Q = jnp.diag(jnp.arange(1.0, 4.0))
    R = jnp.diag(jnp.arange(1.0, 3.0))
    xref = jnp.array([1.0, 2.0, 3.0])
    uref = jnp.array([-1.0, 1.0])
    cost = lqr_cost(Q, R, xref, uref)
    x = jnp.array([0.3, -0.2, 0.5])
    u = jnp.array([0.1, -0.4])
    terms = cost.expand(x, u)
    np.testing.assert_allclose(terms.lxx, Q)
    np.testing.assert_allclose(terms.luu, R)
    np.testing.assert_allclose(terms.lx, Q @ (x - xref))
    np.testing.assert_allclose(terms.lu, R @ (u - uref))
    # value at reference is zero
    np.testing.assert_allclose(cost(xref, uref), 0.0, atol=1e-12)
    # AD expansion agrees with the closed form
    from altro_jax.problem.costs import ad_expansion

    ad = ad_expansion(cost.fn, cost.params, x, u)
    np.testing.assert_allclose(ad.J, terms.J, atol=1e-12)
    np.testing.assert_allclose(ad.lx, terms.lx, atol=1e-12)
    np.testing.assert_allclose(ad.lxu, terms.lxu, atol=1e-12)


def test_quadratic_cost_validation():
    with pytest.raises(ValueError):
        quadratic_cost(jnp.array([[1.0, 2.0], [0.0, 1.0]]), jnp.eye(1))
    with pytest.raises(ValueError):
        lqr_cost(jnp.eye(2), jnp.zeros((1, 1)), jnp.zeros(2), jnp.zeros(1))


def test_control_bound_layout():
    """Finite-bound row layout (`basic_constraints.hpp:94-110`)."""
    con = control_bound([-1.0, -np.inf], [1.0, 2.0])
    assert con.dim == 3
    u = jnp.array([0.5, 3.0])
    c = con(jnp.zeros(3), u)
    # rows: lb0 - u0, u0 - ub0, u1 - ub1
    np.testing.assert_allclose(c, [-1.5, -0.5, 1.0])
    with pytest.raises(ValueError):
        control_bound([1.0], [-1.0])


def test_goal_and_circle_constraints():
    xf = jnp.array([1.0, 2.0, 3.0])
    goal = goal_constraint(xf)
    np.testing.assert_allclose(goal(jnp.zeros(3), jnp.zeros(2)), -xf)
    circ = circle_constraint(jnp.array([1.0]), jnp.array([1.0]), jnp.array([0.5]))
    c = circ(jnp.array([1.0, 1.0, 0.0]), jnp.zeros(2))
    np.testing.assert_allclose(c, [0.25])  # inside: -(-r^2) > 0 violated
    c2 = circ(jnp.array([3.0, 1.0, 0.0]), jnp.zeros(2))
    np.testing.assert_allclose(c2, [-(4.0 - 0.25)])


def test_derivative_checker_known_functions():
    """The FD checker itself, against closed-form derivatives
    (`test/utils/derivative_checker_test.cpp` analog)."""
    from altro_jax.utils.derivative_check import (
        finite_diff,
        finite_diff_gradient,
        finite_diff_hessian,
    )

    f = lambda x: np.array([np.sin(x[0]) * x[1], x[0] ** 2 + x[1] ** 3])
    x = np.array([0.7, -0.4])
    J = finite_diff(f, x)
    J_exact = np.array(
        [[np.cos(0.7) * -0.4, np.sin(0.7)], [2 * 0.7, 3 * (-0.4) ** 2]]
    )
    np.testing.assert_allclose(J, J_exact, atol=1e-7)

    g = lambda x: float(np.sin(x[0]) * x[1] ** 2)
    grad = finite_diff_gradient(g, x)
    np.testing.assert_allclose(
        grad, [np.cos(0.7) * 0.16, np.sin(0.7) * -0.8], atol=1e-7
    )
    H = finite_diff_hessian(g, x)
    H_exact = np.array(
        [
            [-np.sin(0.7) * 0.16, np.cos(0.7) * -0.8],
            [np.cos(0.7) * -0.8, 2 * np.sin(0.7)],
        ]
    )
    np.testing.assert_allclose(H, H_exact, atol=1e-4)


def test_dynamics_hessian_vector_product_unicycle():
    """`hessian_vp` (r5: the reference's FunctionBase::Hessian surface,
    `functionbase.hpp:53-87`) against the unicycle's analytic form
    (`examples/unicycle.cpp:33-43`): for f = [v cosθ, v sinθ, ω],
    ∂²(bᵀf) has -b0 v cosθ - b1 v sinθ at (θ,θ) and
    -b0 sinθ + b1 cosθ at (θ,v), zero elsewhere."""
    from altro_jax.models.unicycle import unicycle

    model = unicycle()
    x = jnp.array([0.3, -0.2, 0.7])
    u = jnp.array([1.1, 0.4])
    b = jnp.array([0.5, -1.2, 2.0])
    H = np.asarray(model.hessian_vp(x, u, 0.0, b))
    assert H.shape == (5, 5)
    th, v = float(x[2]), float(u[0])
    b0, b1 = float(b[0]), float(b[1])
    expect = np.zeros((5, 5))
    expect[2, 2] = -b0 * v * np.cos(th) - b1 * v * np.sin(th)
    expect[2, 3] = expect[3, 2] = -b0 * np.sin(th) + b1 * np.cos(th)
    np.testing.assert_allclose(H, expect, atol=1e-12)

    # discrete (RK4) variant cross-checked by finite differences
    from altro_jax.problem.dynamics import discretize

    dm = discretize(model, "rk4")
    h = 0.05
    Hd = np.asarray(dm.hessian_vp(x, u, 0.0, h, b))
    z0 = np.concatenate([np.asarray(x), np.asarray(u)])

    def grad(z):
        import jax as _jax

        def scalar(zz):
            return jnp.dot(b, dm.fn(dm.params, zz[:3], zz[3:], 0.0, h))

        return np.asarray(_jax.grad(scalar)(jnp.asarray(z)))

    eps = 1e-6
    fd = np.stack(
        [
            (grad(z0 + eps * np.eye(5)[i]) - grad(z0 - eps * np.eye(5)[i]))
            / (2 * eps)
            for i in range(5)
        ]
    )
    np.testing.assert_allclose(Hd, fd, atol=1e-5)
