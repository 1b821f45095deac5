"""f64 polish phase of the compacted solver (r4).

Measured basis: ~11% of the perturbed
three-obstacle fleet ends MAX_PENALTY in f32 while every such instance
solves outright in f64 — an f32 precision floor, not an algorithmic
failure.  `CompactedALSolver(f64_polish=True)` re-solves the residue in
float64 on the scan path and splices the results back.
"""
import jax
import jax.numpy as jnp
import numpy as np

from altro_jax import SolverOptions, SolverStatus
from altro_jax.models.problems import UnicycleProblem
from altro_jax.solver.batched import to_batch_last
from altro_jax.solver.compaction import CompactedALSolver

B = 48  # seed-0 fleet: 8 known f32 failures among the first 48 instances


def _fleet(dtype):
    defn = UnicycleProblem(scenario="three_obstacles", dtype=dtype)
    prob = defn.make_problem(add_constraints=True).compile()
    rng = np.random.default_rng(0)
    x0s = rng.uniform(-0.1, 0.1, size=(3, 256))[:, :B]
    x0s[:, 0] = 0.0
    params = prob.params.replace(x0=jnp.asarray(x0s, dtype))
    Z0 = defn.initial_trajectory()
    Zb = to_batch_last(
        jax.tree_util.tree_map(
            lambda l: jnp.broadcast_to(l, (B,) + l.shape), Z0
        )
    )
    return prob, params, Zb


def test_f64_polish_finishes_f32_residue():
    opts = SolverOptions(
        initial_penalty=1.0, line_search_max_iterations=20,
        max_stall_iterations=10,
    )
    prob, params, Zb = _fleet(jnp.float32)
    base = CompactedALSolver(
        prob, opts, phase1_iters=14, tail_batch=B, f64_polish=False
    )
    res0 = base.solve(params, Zb)
    st0 = np.asarray(res0["status"])
    n_fail = int((st0 != int(SolverStatus.SOLVED)).sum())
    assert n_fail > 0, "fixture no longer produces f32 failures"

    pol = CompactedALSolver(
        prob, opts, phase1_iters=14, tail_batch=B,
        f64_polish=True, polish_batch=16,
    )
    res = pol.solve(params, Zb)
    st = np.asarray(res["status"])
    tel = pol.telemetry["polish"]
    assert tel["instances"] == n_fail
    # every f32 hard failure (MAX_PENALTY etc.) is gone; the only permitted
    # residue is SOLVED_STALLED, which the f64 oracle experiment shows is a
    # FEASIBLE solution whose gradient proxy hovers above tolerance (the
    # reference would end those MAX_INNER_ITERATIONS — strictly worse)
    assert np.all(
        np.isin(st, [int(SolverStatus.SOLVED), int(SolverStatus.SOLVED_STALLED)])
    ), st
    assert (st == int(SolverStatus.SOLVED)).sum() > (
        st0 == int(SolverStatus.SOLVED)
    ).sum()
    stalled = st == int(SolverStatus.SOLVED_STALLED)
    if stalled.any():
        viol = np.asarray(res["stats"].violations)
        assert viol[stalled].max() < 1e-4  # feasible at tolerance
    # polished trajectories respect the constraints they previously violated
    X = np.asarray(res["Z"].X, np.float64)
    defn = UnicycleProblem(scenario="three_obstacles", dtype=jnp.float32)
    cx, cy, r = defn.obstacles
    d = (
        np.sqrt(
            (X[:, 0, None, :] - cx[None, :, None]) ** 2
            + (X[:, 1, None, :] - cy[None, :, None]) ** 2
        )
        - r[None, :, None]
    )
    assert d.min() >= -1e-3  # the reference's own clearance check
    # statuses/trajectories of already-solved instances are untouched
    ok0 = st0 == int(SolverStatus.SOLVED)
    np.testing.assert_array_equal(st[ok0], st0[ok0])
    np.testing.assert_allclose(
        np.asarray(res["Z"].U)[..., ok0], np.asarray(res0["Z"].U)[..., ok0],
        rtol=0, atol=0,
    )
