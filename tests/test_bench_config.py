"""The EXACT shipped bench configuration, executed in CI.

No other test constructs the precise program `bench.py` measures (fused
backward + pallas forward, scan_unroll=4, ls-cap 6, phase1_iters=14,
1024-lane tail), so config drift in the bench would be invisible.  This
module imports the solver factory FROM bench.py — the test and the
measurement cannot diverge — and runs it on CPU (the Pallas kernels execute
in interpret mode there, same kernel code) on the real N=100 parking
problem at B=1024.

Asserts the driver metric's parity half against the f64 reference-default
solve (BASELINE.md:28, golden from perf/make_canonical_golden.py): exact
(5e-14) in f64 via tests/test_control_parity.py, and within the measured
f32 precision envelope here (PARITY.md "Control-sequence parity analysis"
documents why 1e-4 is unreachable for any f32 program at the reference's
own stopping tolerances), plus full status accounting.
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax.numpy as jnp  # noqa: E402

import bench  # noqa: E402
from altro_jax import SolverStatus  # noqa: E402
from altro_jax.models.problems import UnicycleProblem  # noqa: E402

BATCH = 1024


@pytest.fixture(scope="module")
def shipped_solve():
    defn = UnicycleProblem(dtype=jnp.float32)
    prob = defn.make_problem(add_constraints=True).compile()
    solver = bench.make_solver(prob, BATCH)
    # the shipped config must actually select the Pallas kernels
    assert solver.opts.forward_pass == "pallas"
    assert solver.opts.backward_pass == "fused"
    assert solver._p1._fwd is not None
    assert solver._p1._bwd is not None
    params_b, Zb = bench.make_batch(prob, defn, BATCH, jnp.float32)
    res = solver.solve(params_b, Zb)
    return solver, res


def test_shipped_config_canonical_control_parity(shipped_solve):
    """Canonical-element control parity vs the f64 reference solve, under
    the exact measured config.  The bound is the measured f32 precision
    envelope (~2e-4, see PARITY.md "Control-sequence parity analysis"):
    the 1e-4 driver target is met exactly in f64
    (tests/test_control_parity.py); in f32 the reference's own 1e-4
    tolerance ball is ~4e-4 wide in U, so the assert guards the measured
    envelope against precision regressions."""
    _, res = shipped_solve
    U_ref, X_ref, J_ref = bench.load_reference_golden()
    U0 = np.asarray(res["Z"].U[..., 0], np.float64)
    X0 = np.asarray(res["Z"].X[..., 0], np.float64)
    # measured 4.6e-4 on CPU in interpret mode; 7e-4 bounds the stopping ball
    assert float(np.abs(U0 - U_ref).max()) <= 7e-4
    assert float(np.abs(X0 - X_ref).max()) <= 7e-4
    cost0 = float(np.asarray(res["stats"].cost[0], np.float64))
    assert abs(cost0 - J_ref) <= 1e-3 * abs(J_ref)


def test_shipped_config_status_accounting(shipped_solve):
    """Every instance ends in a reported status; ≥99% solve outright
    (r2 gap: one of 4096 instances ended in an unreported code)."""
    _, res = shipped_solve
    status = np.asarray(res["status"])
    hist = bench.status_histogram(status)
    assert sum(hist.values()) == BATCH, hist
    assert hist.get(SolverStatus.SOLVED.name, 0) >= int(0.99 * BATCH), hist
    assert int(status[0]) == int(SolverStatus.SOLVED)


def test_shipped_config_matches_default_config_canonical(shipped_solve):
    """The tuned kernel/layout knobs change performance, not the answer:
    canonical element vs the default-config batch-native solve."""
    _, res = shipped_solve
    defn = UnicycleProblem(dtype=jnp.float32)
    prob = defn.make_problem(add_constraints=True).compile()
    from altro_jax import SolverOptions
    from altro_jax.solver.batched import ALSolverBatched

    ref = ALSolverBatched(prob, SolverOptions())
    params_b, Zb = bench.make_batch(prob, defn, BATCH, jnp.float32)
    res_ref = ref.solve(params_b, Zb)
    U0 = np.asarray(res["Z"].U[..., 0], np.float64)
    U0_ref = np.asarray(res_ref["Z"].U[..., 0], np.float64)
    assert float(np.abs(U0 - U0_ref).max()) <= 2e-4
    assert int(res_ref["status"][0]) == int(SolverStatus.SOLVED)
