"""Inner iLQR solver tests against the reference's Altro.jl-derived goldens.

Golden sources:
  triple integrator: `test/ilqr/ilqr_test.cpp:150-334`
  unicycle turn-90:  `test/ilqr/unicycle_ilqr_test.cpp:27-100`
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from altro_jax import ILQRSolver, SolverOptions, SolverStatus
from altro_jax.models.problems import TripleIntegratorProblem, UnicycleProblem


@pytest.fixture(scope="module")
def tri():
    defn = TripleIntegratorProblem(dof=2)
    prob = defn.make_problem().compile()
    solver = ILQRSolver(prob, SolverOptions())
    Z0 = defn.initial_trajectory()
    return defn, prob, solver, Z0


@pytest.fixture(scope="module")
def uni():
    defn = UnicycleProblem()
    prob = defn.make_problem(add_constraints=False).compile()
    solver = ILQRSolver(prob, SolverOptions())
    Z0 = defn.initial_trajectory()
    return defn, prob, solver, Z0


class TestTripleIntegrator:
    def test_initial_cost(self, tri):
        defn, prob, solver, Z0 = tri
        Z = solver.rollout(prob.params, Z0)
        J0 = solver.fns.total_cost(prob.params, (), Z)
        # zero controls from x0: J = 100 + 1e6 (`ilqr_test.cpp:212-216`)
        np.testing.assert_allclose(J0, 100.0 + 1e6, rtol=1e-12)

    def test_backward_pass_goldens(self, tri):
        defn, prob, solver, Z0 = tri
        Z = solver.rollout(prob.params, Z0)
        exp = solver.expansions(prob.params, (), Z)
        bp = solver.backward_pass(exp)
        # `ilqr_test.cpp:196-204` (Altro.jl values)
        ctg_grad0 = np.array(
            [
                -389.04658272629644,
                -778.0931654525915,
                -181.40881931288234,
                -362.81763862576514,
                -9.704677110465038,
                -19.409354220930084,
            ]
        )
        d0 = np.array([127.9313782698078, 255.862756539616])
        np.testing.assert_allclose(bp.p[0], ctg_grad0, atol=1e-4 * 390)
        np.testing.assert_allclose(bp.d[0], d0, rtol=1e-4)
        assert not bool(bp.failed)

    def test_forward_pass_golden(self, tri):
        defn, prob, solver, Z0 = tri
        Z = solver.rollout(prob.params, Z0)
        exp = solver.expansions(prob.params, (), Z)
        J0 = exp.costs.sum()
        bp = solver.backward_pass(exp)
        fp = solver.forward_pass(prob.params, (), Z, bp, J0)
        assert bool(fp.success)
        # `ilqr_test.cpp:268-269`
        np.testing.assert_allclose(fp.J, 1945.2329136, atol=1e-3)

    def test_full_solve(self, tri):
        defn, prob, solver, Z0 = tri
        res = solver.solve(prob.params, (), Z0)
        assert int(res.status) == SolverStatus.SOLVED
        # exactly 2 inner iterations (`ilqr_test.cpp:304-311`)
        assert int(res.stats.iterations_inner) == 2
        # feedback gain golden (`ilqr_test.cpp:291-297`)
        K0 = np.array(
            [
                [-63.9657, 0.0, -42.7673, 0.0, -11.5189, 0.0],
                [0.0, -63.9657, 0.0, -42.7673, 0.0, -11.5189],
            ]
        )
        np.testing.assert_allclose(res.K[0], K0, rtol=2e-5, atol=1e-3)
        assert float(jnp.abs(res.d).max()) < 1e-8


class TestUnicycle:
    def test_initial_cost(self, uni):
        defn, prob, solver, Z0 = uni
        Z = solver.rollout(prob.params, Z0)
        J = solver.fns.total_cost(prob.params, (), Z)
        # `unicycle_ilqr_test.cpp:36-38` (Altro.jl)
        np.testing.assert_allclose(J, 259.27636137767087, atol=1e-5)

    def test_backward_pass_goldens(self, uni):
        defn, prob, solver, Z0 = uni
        Z = solver.rollout(prob.params, Z0)
        exp = solver.expansions(prob.params, (), Z)
        bp = solver.backward_pass(exp)
        # `unicycle_ilqr_test.cpp:45-53`
        ctg_grad0 = np.array(
            [0.024904637422419617, -0.46496022574032614, -0.0573096310550007]
        )
        d0 = np.array([-2.565783457444465, 5.514158930898376])
        np.testing.assert_allclose(bp.p[0], ctg_grad0, atol=1e-5)
        np.testing.assert_allclose(bp.d[0], d0, atol=1e-5 * 5.5)

    def test_forward_pass_alpha(self, uni):
        defn, prob, solver, Z0 = uni
        Z = solver.rollout(prob.params, Z0)
        exp = solver.expansions(prob.params, (), Z)
        J0 = exp.costs.sum()
        bp = solver.backward_pass(exp)
        fp = solver.forward_pass(prob.params, (), Z, bp, J0)
        assert bool(fp.success)
        assert float(fp.J) < float(J0)
        # line search settles at alpha = 0.0625 (`unicycle_ilqr_test.cpp:56-64`)
        np.testing.assert_allclose(fp.alpha, 0.0625)

    def test_two_steps_goldens(self, uni):
        defn, prob, solver, Z0 = uni
        Z = solver.rollout(prob.params, Z0)
        from altro_jax.solver.riccati import decrease_regularization

        rho = jnp.asarray(0.0)
        drho = jnp.asarray(0.0)
        # iteration 1
        exp = solver.expansions(prob.params, (), Z)
        bp = solver.backward_pass(exp, rho, drho)
        rho, drho = decrease_regularization(bp.rho, bp.drho, solver.opts)
        fp = solver.forward_pass(prob.params, (), Z, bp, exp.costs.sum())
        Z = fp.Z
        # iteration 2 backward pass
        exp = solver.expansions(prob.params, (), Z)
        bp = solver.backward_pass(exp, rho, drho)
        # `unicycle_ilqr_test.cpp:67-88`
        ctg_grad0 = np.array(
            [-0.0015143873973949232, -0.07854630832127288, -0.017945283678268698]
        )
        d0 = np.array([0.21887571453613042, 1.3097976615154625])
        np.testing.assert_allclose(bp.p[0], ctg_grad0, atol=1e-5)
        np.testing.assert_allclose(bp.d[0], d0, atol=1e-5 * 1.3)
        fp = solver.forward_pass(prob.params, (), Z, bp, exp.costs.sum())
        np.testing.assert_allclose(fp.J, 62.773696055304384, atol=1e-5)

    def test_full_solve(self, uni):
        defn, prob, solver, Z0 = uni
        res = solver.solve(prob.params, (), Z0)
        assert int(res.status) == SolverStatus.SOLVED
        # 9 iterations, J = 0.0387016567 (`unicycle_ilqr_test.cpp:90-100`)
        assert int(res.stats.iterations_inner) == 9
        J = solver.fns.total_cost(prob.params, (), res.Z)
        np.testing.assert_allclose(J, 0.0387016567, atol=1e-5)
        assert float(res.stats.gradient) < solver.opts.gradient_tolerance


class TestStallStatus:
    """The numerical-floor stall exit must report SOLVED_STALLED, never plain
    SOLVED (VERDICT r1: stall folded into `converged` masked non-convergence)."""

    def test_unreachable_gradient_tolerance_reports_stalled(self, tri):
        defn, prob, solver, Z0 = tri
        # gradient_tolerance=0 is unreachable; dJ hits the floor immediately
        # after the 2-iteration converging solve, so the stall exit fires.
        opts = SolverOptions(gradient_tolerance=0.0, max_stall_iterations=3)
        s = ILQRSolver(prob, opts)
        res = s.solve(prob.params, (), Z0)
        assert int(res.status) == SolverStatus.SOLVED_STALLED
        assert int(res.status) != SolverStatus.SOLVED

    def test_stall_disabled_reports_max_iterations(self, tri):
        defn, prob, solver, Z0 = tri
        opts = SolverOptions(
            gradient_tolerance=0.0, max_stall_iterations=0,
            max_iterations_inner=12, max_iterations_total=12,
        )
        s = ILQRSolver(prob, opts)
        res = s.solve(prob.params, (), Z0)
        assert int(res.status) in (
            SolverStatus.MAX_INNER_ITERATIONS, SolverStatus.MAX_ITERATIONS
        )

    def test_normal_solve_not_stalled(self, tri):
        """Goldens converge the same iteration dJ and gradient cross tolerance;
        the stall path must not fire on a normally-converging solve."""
        defn, prob, solver, Z0 = tri
        res = solver.solve(prob.params, (), Z0)
        assert int(res.status) == SolverStatus.SOLVED
