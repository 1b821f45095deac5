"""Parallel-Riccati (pscan) under forced regularization: full-solve goldens.

Round-2 gap (VERDICT weak #6): `pscan_batched` was only checked against
`solver/pscan.py`, which makes the same regularize-the-element choice, and
the claim that the rho>0 variant is "a valid damped-Newton step"
(pscan_batched.py docstring) was asserted, never tested.  These tests force
rho > 0 from the first backward pass (`bp_reg_initial=1.0`, the reference
knob `solver_options.hpp:31`) and require both pscan layouts to still solve
the unicycle turn-90 golden problem to the reference optimum
(J = 0.0387016567, `unicycle_ilqr_test.cpp:94-96`), with bounded iteration
inflation vs the sequential backward pass under the same regularization.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from altro_jax import ALSolver, ILQRSolver, SolverOptions, SolverStatus
from altro_jax.models.problems import UnicycleProblem
from altro_jax.solver.batched import ALSolverBatched, to_batch_last

J_GOLDEN = 0.0387016567  # unicycle_ilqr_test.cpp:94-96 (unconstrained)


@pytest.fixture(scope="module")
def parking():
    defn = UnicycleProblem()
    prob = defn.make_problem(add_constraints=False).compile()
    return defn, prob


def _opts(backward="scan", **kw):
    # bp_reg_initial=1.0 forces rho=1 into the FIRST backward pass; the
    # schedule then decays it (`ilqr.hpp:770-786`), so early iterations are
    # genuinely damped and late ones approach the pure Newton step.
    return SolverOptions(backward_pass=backward, bp_reg_initial=1.0, **kw)


def _patch_pscan(solver):
    """Route a solver's backward sweep through the RETIRED pscan research
    implementation (the backward_pass='pscan' OPTION was removed in r5 —
    measured slower everywhere, PARITY.md:149-178 — but the implementation
    stays validated as a research note via these tests)."""
    from altro_jax.solver import pscan

    if isinstance(solver, ALSolverBatched):
        from altro_jax.solver.pscan_batched import riccati_pscan_batched

        solver.riccati_scan = lambda exp, rho: riccati_pscan_batched(
            exp, rho, gain_limit=solver.opts.bp_gain_limit
        )
    else:

        def bp(exp, rho=0.0, drho=0.0):
            rho = jnp.asarray(rho, exp.A.dtype)
            drho = jnp.asarray(drho, exp.A.dtype)
            return pscan.backward_pass_pscan(exp, rho, drho, solver.opts)

        solver.backward_pass = bp
    return solver


@pytest.fixture(scope="module")
def scan_reg_solve(parking):
    defn, prob = parking
    solver = ILQRSolver(prob, _opts("scan"))
    res = jax.jit(solver.solve)(prob.params, (), defn.initial_trajectory())
    return res


def test_scan_solves_golden_under_forced_reg(scan_reg_solve):
    res = scan_reg_solve
    assert int(res.status) == int(SolverStatus.SOLVED)
    np.testing.assert_allclose(float(res.stats.cost), J_GOLDEN, rtol=1e-6)


def test_pscan_per_instance_solves_golden_under_forced_reg(
    parking, scan_reg_solve
):
    """The per-instance associative-scan backward pass at rho>0 reaches the
    same optimum: the damped step differs from the sequential one by
    construction (regularized vs mixed propagation), but both must converge
    to the reference J with bounded iteration inflation."""
    defn, prob = parking
    solver = _patch_pscan(ILQRSolver(prob, _opts()))
    res = jax.jit(solver.solve)(prob.params, (), defn.initial_trajectory())
    assert int(res.status) == int(SolverStatus.SOLVED)
    np.testing.assert_allclose(float(res.stats.cost), J_GOLDEN, rtol=1e-6)
    it_scan = int(scan_reg_solve.stats.iterations_total)
    it_pscan = int(res.stats.iterations_total)
    assert it_pscan <= 2 * it_scan + 2, (it_pscan, it_scan)


def test_pscan_batched_solves_golden_under_forced_reg(parking, scan_reg_solve):
    """Batch-last pscan layout, same forced-regularization golden."""
    defn, prob = parking
    B = 4
    Z0 = defn.initial_trajectory()
    Zb = to_batch_last(
        jax.tree_util.tree_map(
            lambda l: jnp.broadcast_to(l, (B,) + l.shape), Z0
        )
    )
    fb = _patch_pscan(ALSolverBatched(prob, _opts()))
    res = jax.jit(fb.solve)(prob.params, Zb)
    assert np.all(np.asarray(res["status"]) == int(SolverStatus.SOLVED))
    np.testing.assert_allclose(
        np.asarray(res["stats"].cost), J_GOLDEN, rtol=1e-6
    )
    it_scan = int(scan_reg_solve.stats.iterations_total)
    it = int(np.asarray(res["stats"].iterations_total).max())
    assert it <= 2 * it_scan + 2, (it, it_scan)


def test_pscan_constrained_al_solve_under_forced_reg(parking):
    """Full constrained AL solve (goal + bounds) with pscan backward at
    forced rho: reference AL golden J=0.03893465058924039 at tol 1e-6
    (`auglag_test.cpp:346-349`)."""
    defn = UnicycleProblem()
    prob = defn.make_problem(add_constraints=True).compile()
    solver = ALSolver(
        prob,
        SolverOptions(bp_reg_initial=1.0, constraint_tolerance=1e-6),
    )
    _patch_pscan(solver.ilqr)
    res = jax.jit(solver.solve)(prob.params, defn.initial_trajectory())
    assert int(res.status) == int(SolverStatus.SOLVED)
    # Compare the RAW trajectory cost: the damped pscan path takes more
    # outer iterations, so the recorded AL cost carries larger residual
    # dual terms; the solution itself is the reference optimum.
    al0 = solver.fns.al_state_init(jnp.float64)
    J_raw = float(solver.fns.total_cost(prob.params, al0, res.Z))
    np.testing.assert_allclose(J_raw, 0.03893465058924039, rtol=1e-6)
    assert float(res.stats.violations) < 1e-6
