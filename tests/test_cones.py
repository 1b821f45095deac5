"""Cone tests: projections, Jacobians, conic-AL solve.

Zero/NegativeOrthant semantics mirror `altro/constraints/constraint.hpp`;
the second-order cone extends the conic-AL capability beyond the reference's
shipped set.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from altro_jax import (
    ALSolver,
    Cone,
    Constraint,
    SolverOptions,
    SolverStatus,
)
from altro_jax.problem.constraints import (
    cone_jacobian,
    cone_jacobian_diag,
    cone_project,
    cone_violation,
    dual_cone,
)
from altro_jax.models.problems import UnicycleProblem
from altro_jax.utils.derivative_check import finite_diff


def test_basic_cone_projections():
    x = jnp.array([1.0, -2.0, 0.5])
    np.testing.assert_allclose(cone_project(Cone.ZERO, x), 0.0)
    np.testing.assert_allclose(cone_project(Cone.IDENTITY, x), x)
    np.testing.assert_allclose(
        cone_project(Cone.NEGATIVE_ORTHANT, x), [0.0, -2.0, 0.0]
    )
    # Jacobian convention: 1 where x <= 0 (`constraint.hpp:108`)
    np.testing.assert_allclose(
        cone_jacobian_diag(Cone.NEGATIVE_ORTHANT, x), [0.0, 1.0, 0.0]
    )
    assert dual_cone(Cone.ZERO) is Cone.IDENTITY
    assert dual_cone(Cone.NEGATIVE_ORTHANT) is Cone.NEGATIVE_ORTHANT
    assert dual_cone(Cone.SECOND_ORDER) is Cone.SECOND_ORDER


@pytest.mark.parametrize(
    "x",
    [
        [0.3, 0.2, 1.0],  # inside
        [3.0, 4.0, -6.0],  # polar region
        [3.0, 4.0, 1.0],  # boundary projection region
    ],
)
def test_soc_projection_properties(x):
    x = jnp.asarray(x)
    p = cone_project(Cone.SECOND_ORDER, x)
    # projection lands in the cone
    assert float(jnp.linalg.norm(p[:-1])) <= float(p[-1]) + 1e-12
    # idempotent
    np.testing.assert_allclose(cone_project(Cone.SECOND_ORDER, p), p, atol=1e-12)
    # Moreau: x = proj_K(x) - proj_K(-x) for self-dual K
    q = cone_project(Cone.SECOND_ORDER, -x)
    np.testing.assert_allclose(p - q, x, atol=1e-12)


def test_soc_jacobian_matches_fd():
    for x0 in ([3.0, 4.0, 1.0], [0.1, 0.2, 5.0], [1.0, 1.0, -9.0]):
        x = np.asarray(x0)
        J = np.asarray(cone_jacobian(Cone.SECOND_ORDER, jnp.asarray(x)))
        Jfd = finite_diff(
            lambda y: np.asarray(cone_project(Cone.SECOND_ORDER, jnp.asarray(y))), x
        )
        np.testing.assert_allclose(J, Jfd, atol=1e-6)


def test_conic_al_solve():
    """Unicycle parking with a thrust-cone-style control constraint
    |v| <= w_slack: c = (u0, 1.2 - |u1|...) — use c = (u0, cap) in SOC form
    requiring ‖u0‖ <= cap with cap fixed: c = (u[0], 1.0)."""
    defn = UnicycleProblem()
    prob_builder = defn.make_problem(add_constraints=False)

    def soc_fn(params, x, u):
        del x
        # require |v| <= vmax via SOC: (v, vmax) in K
        return jnp.stack([u[0], params["vmax"]])

    soc = Constraint(
        params={"vmax": jnp.asarray(0.8)},
        fn=soc_fn,
        cone=Cone.SECOND_ORDER,
        dim=2,
        label="Velocity SOC",
    )
    prob_builder.set_constraint(soc, range(defn.N))
    prob = prob_builder.compile()
    solver = ALSolver(prob, SolverOptions())
    res = solver.solve(prob.params, defn.initial_trajectory())
    assert int(res.status) == SolverStatus.SOLVED
    U = np.asarray(res.Z.U)
    assert np.abs(U[:, 0]).max() <= 0.8 + 1e-3
    assert float(res.stats.violations) < solver.opts.constraint_tolerance
