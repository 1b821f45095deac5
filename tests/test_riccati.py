"""Riccati kernel tests: associative-scan vs sequential, regularization retry.

The parallel-prefix backward pass (arXiv:1809.06360) replaces the
reference's strictly sequential recursion (`ilqr/ilqr.hpp:402-441`); it must
agree with the sequential oracle, and the Cholesky-failure retry loop must
reproduce the reference's regularization schedule (`ilqr.hpp:409-427,770-786`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from altro_jax import ILQRSolver, SolverOptions, SolverStatus
from altro_jax.models.problems import UnicycleProblem
from altro_jax.solver import pscan, riccati


@pytest.fixture(scope="module")
def uni_exp():
    defn = UnicycleProblem()
    prob = defn.make_problem(add_constraints=False).compile()
    solver = ILQRSolver(prob, SolverOptions())
    Z = solver.rollout(prob.params, defn.initial_trajectory())
    return solver, solver.expansions(prob.params, (), Z)


def test_pscan_matches_sequential(uni_exp):
    solver, exp = uni_exp
    z = jnp.zeros(())
    bp_seq = riccati.backward_pass(exp, z, z, solver.opts)
    bp_par = pscan.backward_pass_pscan(exp, z, z, solver.opts)
    for name in ("K", "d", "P", "p", "dV1", "dV2"):
        a = np.asarray(getattr(bp_seq, name))
        b = np.asarray(getattr(bp_par, name))
        scale = np.max(np.abs(a)) + 1e-12
        np.testing.assert_allclose(b, a, atol=1e-10 * scale, err_msg=name)
    assert not bool(bp_par.failed)


def test_pscan_full_solve_matches():
    """Unicycle inner solve via pscan: same 9 iterations and cost."""
    defn = UnicycleProblem()
    prob = defn.make_problem(add_constraints=False).compile()
    solver = ILQRSolver(prob, SolverOptions())
    # backward_pass="pscan" was RETIRED as an option in r5 (measured
    # slower everywhere, PARITY.md) — drive the research implementation
    # directly to keep it validated at full-solve level
    _bp = solver.backward_pass

    def _pscan_bp(exp, rho=0.0, drho=0.0):
        rho = jnp.asarray(rho, exp.A.dtype)
        drho = jnp.asarray(drho, exp.A.dtype)
        return pscan.backward_pass_pscan(exp, rho, drho, solver.opts)

    solver.backward_pass = _pscan_bp
    res = solver.solve(prob.params, (), defn.initial_trajectory())
    assert int(res.status) == SolverStatus.SOLVED
    assert int(res.stats.iterations_inner) == 9
    J = solver.fns.total_cost(prob.params, (), res.Z)
    np.testing.assert_allclose(J, 0.0387016567, atol=1e-5)


def test_regularization_retry_recovers(uni_exp):
    """A non-PD Quu at one knot must trigger retries that increase rho until
    the pass succeeds (`ilqr.hpp:409-427`)."""
    solver, exp = uni_exp
    luu_bad = exp.luu.at[3].set(jnp.diag(jnp.array([-1.0, -1.0])))
    exp_bad = exp.replace(luu=luu_bad)
    z = jnp.zeros(())
    bp = riccati.backward_pass(exp_bad, z, z, solver.opts)
    assert not bool(bp.failed)
    assert float(bp.rho) >= 1.0  # had to regularize past the negative diag
    assert np.all(np.isfinite(np.asarray(bp.K)))


def test_regularization_gives_up():
    """With a tiny reg ceiling and tiny fail threshold the pass reports
    BACKWARD_PASS_REGULARIZATION_FAILED (`ilqr.hpp:418-426`)."""
    defn = UnicycleProblem()
    prob = defn.make_problem(add_constraints=False).compile()
    opts = SolverOptions(bp_reg_max=1e-6, bp_reg_fail_threshold=2)
    solver = ILQRSolver(prob, opts)
    Z = solver.rollout(prob.params, defn.initial_trajectory())
    exp = solver.expansions(prob.params, (), Z)
    exp_bad = exp.replace(luu=exp.luu.at[:].set(jnp.diag(jnp.array([-1.0, -1.0]))))
    bp = riccati.backward_pass(exp_bad, jnp.zeros(()), jnp.zeros(()), opts)
    assert bool(bp.failed)
    assert int(bp.status) == SolverStatus.BACKWARD_PASS_REGULARIZATION_FAILED


def test_gain_limit_guard_triggers_retry(uni_exp):
    """A finite-but-numerically-singular Quu passes the NaN-only Cholesky
    check (`jnp.linalg.cholesky` of a tiny-positive matrix is finite) and
    would emit astronomically large gains; the r4 gain-magnitude guard
    (SolverOptions.bp_gain_limit) counts it as failure so the retry loop
    regularizes instead (the quadrotor order-dependent-failure fix, see
    perf/quadrotor_path_stability.py)."""
    solver, exp = uni_exp
    # make every Quu tiny-but-positive: luu ~ 1e-30 I and B scaled so the
    # BᵀPB term cannot rescue conditioning — Cholesky stays FINITE
    m = exp.luu.shape[-1]
    sick = exp.replace(
        luu=jnp.broadcast_to(jnp.eye(m) * 1e-30, exp.luu.shape),
        B=exp.B * 1e-15,
    )
    z = jnp.zeros(())
    # pre-guard sweep at rho=0: NO failure flagged despite garbage gains —
    # the structural hole
    K, d, *_, failed = riccati._riccati_scan(sick, z, gain_limit=jnp.inf)
    assert not bool(failed)
    big = max(float(jnp.max(jnp.abs(K))), float(jnp.max(jnp.abs(d))))
    assert big > 1e8, big
    # guarded sweep flags it ...
    *_, failed_g = riccati._riccati_scan(sick, z, gain_limit=1e8)
    assert bool(failed_g)
    # ... and the full retry loop recovers via regularization
    bp = riccati.backward_pass(sick, z, z, solver.opts)
    assert not bool(bp.failed)
    assert float(jnp.max(jnp.abs(bp.K))) <= solver.opts.bp_gain_limit
    assert float(jnp.max(jnp.abs(bp.d))) <= solver.opts.bp_gain_limit
    assert float(bp.rho) > 0.0
