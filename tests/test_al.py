"""Augmented-Lagrangian solver tests against reference goldens.

Golden sources:
  AL cost values:   `test/augmented_lagrangian/auglag_test.cpp:49-93`
  AL full solve:    `auglag_test.cpp:325-351` (14 total / 5 outer iterations)
  AL-cost inner solve: `test/ilqr/unicycle_ilqr_test.cpp:115-144`
  penalty / dual goldens: `test/examples/example_unicycle_test.cpp:30-67`
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from altro_jax import ALSolver, ILQRSolver, SolverOptions, SolverStatus
from altro_jax.models.problems import TripleIntegratorProblem, UnicycleProblem


@pytest.fixture(scope="module")
def uni_constrained():
    defn = UnicycleProblem()
    prob = defn.make_problem(add_constraints=True).compile()
    return defn, prob


def test_al_cost_value(uni_constrained):
    """AL penalty adds 0.5*rho*violation^2 for a violated inequality with
    zero duals (`auglag_test.cpp:49-64`)."""
    defn, prob = uni_constrained
    solver = ALSolver(prob, SolverOptions())
    rho = 1.1
    v_violation = 0.5
    x = jnp.array([0.1, 0.2, jnp.pi / 3])
    u = jnp.array([defn.v_bnd + v_violation, defn.w_bnd / 2])
    al = solver.fns.set_penalty(solver.init_al_state(), rho)
    # evaluate knot-0 cost: state cost + bound penalty
    Z = defn.initial_trajectory()
    Z = Z.replace(X=Z.X.at[0].set(x), U=Z.U.at[0].set(u))
    costs = solver.fns.cost_terms(prob.params, al, Z)
    from altro_jax.problem.costs import lqr_cost

    stage = lqr_cost(defn.Q, defn.R, defn.xf, defn.uref)
    J_cost = stage(x, u)
    np.testing.assert_allclose(
        costs[0], J_cost + 0.5 * rho * v_violation**2, rtol=1e-12
    )


def test_al_gradient_matches_fd(uni_constrained):
    """AL cost expansion gradient vs finite differences, active inequality
    (`auglag_test.cpp:66-93`)."""
    defn, prob = uni_constrained
    solver = ALSolver(prob, SolverOptions())
    rho = 1.1
    al = solver.fns.set_penalty(solver.init_al_state(), rho)
    # nonzero duals on the bound constraint to exercise the general path
    al = tuple(
        s.replace(lam=s.lam - 0.37 * (i + 1)) for i, s in enumerate(al)
    )
    x = jnp.array([0.1, 0.2, jnp.pi / 3])
    u = jnp.array([defn.v_bnd + 0.5, defn.w_bnd / 2])
    Z = defn.initial_trajectory()
    Z = Z.replace(X=Z.X.at[0].set(x), U=Z.U.at[0].set(u))

    def knot0_cost(xu):
        Zk = Z.replace(X=Z.X.at[0].set(xu[:3]), U=Z.U.at[0].set(xu[3:]))
        return solver.fns.cost_terms(prob.params, al, Zk)[0]

    exp = solver.fns.expand(prob.params, al, Z)
    g_ad = jnp.concatenate([exp.lx[0], exp.lu[0]])
    from altro_jax.utils.derivative_check import finite_diff_gradient

    g_fd = finite_diff_gradient(lambda z: float(knot0_cost(jnp.asarray(z))), np.concatenate([x, u]))
    np.testing.assert_allclose(g_ad, g_fd, atol=1e-5)


@pytest.fixture(scope="module")
def uni_obstacles():
    defn = UnicycleProblem(scenario="three_obstacles")
    prob = defn.make_problem(add_constraints=True).compile()
    return defn, prob


def test_three_obstacle_construction_goldens(uni_obstacles):
    """Initial-rollout costs for the three-obstacle scenario
    (`example_unicycle_test.cpp:18-28`): base J = 133.1151550141444,
    AL cost at penalty 1 = 141.9639680271223."""
    defn, prob = uni_obstacles
    solver = ALSolver(prob, SolverOptions())
    Z = solver.ilqr.rollout(prob.params, defn.initial_trajectory())
    # base cost: zero out AL terms by zero penalty trick — use unconstrained problem
    prob_uncon = defn.make_problem(add_constraints=False)
    # (still has obstacle constraints at knots 1..N-1; remove for base cost)
    from altro_jax.models.problems import UnicycleProblem as UP

    defn2 = UP(scenario="three_obstacles")
    defn2.obstacles = None
    prob2 = defn2.make_problem(add_constraints=False).compile()
    solver2 = ALSolver(prob2, SolverOptions())
    J = solver2.fns.total_cost(prob2.params, (), Z)
    np.testing.assert_allclose(J, 133.1151550141444, atol=1e-6)
    Jal = solver.fns.total_cost(prob.params, solver.init_al_state(), Z)
    np.testing.assert_allclose(Jal, 141.9639680271223, atol=1e-6)


def test_increase_penalty_golden(uni_obstacles):
    """SetPenalty(10) on the initial rollout: J = 221.6032851439234
    (`example_unicycle_test.cpp:30-50`)."""
    defn, prob = uni_obstacles
    solver = ALSolver(prob, SolverOptions())
    ilqr = solver.ilqr
    Z = ilqr.rollout(prob.params, defn.initial_trajectory())
    al1 = solver.init_al_state()  # penalty 1.0
    al10 = solver.fns.set_penalty(al1, 10.0)
    J10 = solver.fns.total_cost(prob.params, al10, Z)
    np.testing.assert_allclose(J10, 221.6032851439234, atol=1e-6)


def test_solve_one_step_duals_golden(uni_obstacles):
    """Inner solve at penalty 10, then dual update: goal duals match Altro.jl
    (negated sign convention) (`example_unicycle_test.cpp:52-67`)."""
    defn, prob = uni_obstacles
    solver = ALSolver(prob, SolverOptions())
    Z0 = defn.initial_trajectory()
    al = solver.fns.set_penalty(solver.init_al_state(), 10.0)
    res = solver.ilqr.solve(prob.params, al, Z0)
    al2 = solver.update_duals(prob.params, res.Z, al)
    lambdaN = np.array(
        [0.43555910438329626, -0.5998598475208317, 0.0044282251970790935]
    )
    # goal constraint is the equality family
    from altro_jax.problem.constraints import Cone

    goal_idx = next(
        i
        for i, f in enumerate(prob.constraint_families)
        if f.cone == Cone.ZERO
    )
    np.testing.assert_allclose(al2[goal_idx].lam[0], -lambdaN, atol=1e-6)


def test_alcost_inner_solve_goldens(uni_constrained):
    """iLQR on the AL cost with default penalties: 10 iterations,
    J = 0.03893427133384412, max bound violation golden
    (`unicycle_ilqr_test.cpp:115-144`)."""
    defn, prob = uni_constrained
    solver = ALSolver(prob, SolverOptions())
    Z0 = defn.initial_trajectory()
    al = solver.init_al_state()
    res = solver.ilqr.solve(prob.params, al, Z0)
    assert int(res.status) == SolverStatus.SOLVED
    assert int(res.stats.iterations_inner) == 10
    J = solver.fns.total_cost(prob.params, al, res.Z)

    U = np.asarray(res.Z.U)
    v_max = np.abs(U[:, 0]).max()
    w_max = np.abs(U[:, 1]).max()
    max_violation = max(v_max - defn.v_bnd, w_max - defn.w_bnd)
    J_expected = 0.03893427133384412
    viol_expected = 0.00017691645708972636
    assert abs(J - J_expected) / J_expected < 1e-6
    assert abs(max_violation - viol_expected) / viol_expected < 1e-6


def test_al_full_solve_goldens(uni_constrained):
    """Full AL solve, tol 1e-6: 14 total / 5 outer iterations,
    J = 0.03893465058924039 (`auglag_test.cpp:325-351`)."""
    defn, prob = uni_constrained
    opts = SolverOptions(constraint_tolerance=1e-6)
    solver = ALSolver(prob, opts)
    res = solver.solve(prob.params, defn.initial_trajectory())
    assert int(res.status) == SolverStatus.SOLVED
    assert int(res.stats.iterations_total) == 14
    assert int(res.stats.iterations_outer) == 5
    J = solver.ilqr.fns.total_cost(prob.params, res.al, res.Z)
    # final AL cost ~= true cost at tiny violation; compare true cost via the
    # converged penalty state like the reference's Cost() call
    np.testing.assert_allclose(J, 0.03893465058924039, rtol=1e-9, atol=1e-12)
    assert float(res.stats.violations) < opts.constraint_tolerance


def test_al_solve_twice_warm_then_reset(uni_constrained):
    """Re-solving from the reset initial trajectory reproduces identical
    stats (`auglag_test.cpp:353-380`)."""
    defn, prob = uni_constrained
    opts = SolverOptions(constraint_tolerance=1e-6)
    solver = ALSolver(prob, opts)
    Z0 = defn.initial_trajectory()
    res1 = solver.solve(prob.params, Z0)
    res2 = solver.solve(prob.params, Z0)
    assert int(res2.stats.iterations_total) == int(res1.stats.iterations_total)
    assert int(res2.stats.iterations_outer) == int(res1.stats.iterations_outer)
    np.testing.assert_array_equal(res1.Z.U, res2.Z.U)


def test_triple_integrator_constrained():
    """Constrained triple integrator: goal reached, controls saturate at the
    bound (`example_triple_integrator_test.cpp:39-69`)."""
    defn = TripleIntegratorProblem(dof=2)
    prob = defn.make_problem(add_constraints=True).compile()
    solver = ALSolver(prob, SolverOptions())
    res = solver.solve(prob.params, defn.initial_trajectory())
    assert int(res.status) == SolverStatus.SOLVED
    assert float(res.stats.violations) < solver.opts.constraint_tolerance
    xf_err = np.abs(np.asarray(res.Z.X[-1]) - defn.xf).max()
    assert xf_err < solver.opts.constraint_tolerance
    np.testing.assert_allclose(res.Z.U[0], defn.ubnd, rtol=1e-6)
    np.testing.assert_allclose(res.Z.U[-1], defn.ubnd, rtol=1e-6)


def test_unicycle_obstacles_feasible():
    """Three-obstacle scenario: solved and min 1mm clearance
    (`example_unicycle_test.cpp:69-89`)."""
    defn = UnicycleProblem(scenario="three_obstacles")
    prob = defn.make_problem(add_constraints=True).compile()
    solver = ALSolver(prob, SolverOptions())
    al = solver.fns.set_penalty(solver.init_al_state(), 10.0)
    opts_np = SolverOptions(initial_penalty=10.0)
    solver = ALSolver(prob, opts_np)
    res = solver.solve(prob.params, defn.initial_trajectory())
    assert int(res.status) == SolverStatus.SOLVED
    cx, cy, cr = defn.obstacles
    X = np.asarray(res.Z.X)
    for i in range(3):
        dist = np.sqrt((X[:, 0] - cx[i]) ** 2 + (X[:, 1] - cy[i]) ** 2) - cr[i]
        assert dist.min() > -1e-3
    assert float(res.stats.violations) < solver.opts.constraint_tolerance
