"""Batch-native solver parity: ALSolverBatched must reproduce the
per-instance solver element-by-element.

This is the batched analog of the reference's serial-vs-multithreaded
determinism tests (`test/examples/example_unicycle_test.cpp:91-167`): the
same work done through a differently-parallelized path must give the same
answer.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from altro_jax import ALSolver, SolverOptions, SolverStatus, ProblemParams
from altro_jax.models.problems import TripleIntegratorProblem, UnicycleProblem
from altro_jax.solver.batched import (
    ALSolverBatched,
    from_batch_last,
    to_batch_last,
)


def _batchify(defn, prob, B, seed=0, spread=0.1):
    rng = np.random.default_rng(seed)
    x0s = jnp.asarray(
        np.asarray(defn.x0)[None, :]
        + rng.uniform(-spread, spread, size=(B, len(defn.x0)))
    )
    params_b = prob.params.replace(x0=x0s)
    Z0 = defn.initial_trajectory()
    Zb = jax.tree_util.tree_map(
        lambda leaf: jnp.broadcast_to(leaf, (B,) + leaf.shape), Z0
    )
    return params_b, Zb


@pytest.mark.parametrize("scenario", ["turn90"])
def test_batched_matches_per_instance_constrained(scenario):
    B = 4
    defn = UnicycleProblem(scenario=scenario)
    prob = defn.make_problem(add_constraints=True).compile()
    opts = SolverOptions(constraint_tolerance=1e-6)
    params_b, Zb = _batchify(defn, prob, B)

    # per-instance reference path (vmapped)
    ref = ALSolver(prob, opts)
    axes = ProblemParams(x0=0, dynamics=None, costs=None, constraints=None)
    res_ref = jax.vmap(ref.solve, in_axes=(axes, 0, None))(params_b, Zb, None)

    # batch-native path
    fast = ALSolverBatched(prob, opts)
    x0_bl = jnp.moveaxis(params_b.x0, 0, -1)
    res_b = fast.solve(params_b.replace(x0=x0_bl), to_batch_last(Zb))
    Zf = from_batch_last(res_b["Z"])

    np.testing.assert_array_equal(np.asarray(res_b["status"]), np.asarray(res_ref.status))
    np.testing.assert_array_equal(
        np.asarray(res_b["stats"].iterations_total),
        np.asarray(res_ref.stats.iterations_total),
    )
    np.testing.assert_array_equal(
        np.asarray(res_b["stats"].iterations_outer),
        np.asarray(res_ref.stats.iterations_outer),
    )
    np.testing.assert_allclose(Zf.U, res_ref.Z.U, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(
        np.asarray(res_b["stats"].violations),
        np.asarray(res_ref.stats.violations),
        rtol=1e-6,
        atol=1e-12,
    )


def test_batched_matches_per_instance_unconstrained():
    B = 3
    defn = TripleIntegratorProblem(dof=2)
    prob = defn.make_problem(add_constraints=False).compile()
    opts = SolverOptions()
    params_b, Zb = _batchify(defn, prob, B, spread=0.5)

    ref = ALSolver(prob, opts)
    axes = ProblemParams(x0=0, dynamics=None, costs=None, constraints=None)
    res_ref = jax.vmap(ref.solve, in_axes=(axes, 0, None))(params_b, Zb, None)

    fast = ALSolverBatched(prob, opts)
    x0_bl = jnp.moveaxis(params_b.x0, 0, -1)
    res_b = fast.solve(params_b.replace(x0=x0_bl), to_batch_last(Zb))
    Zf = from_batch_last(res_b["Z"])

    np.testing.assert_array_equal(np.asarray(res_b["status"]), np.asarray(res_ref.status))
    np.testing.assert_allclose(Zf.U, res_ref.Z.U, rtol=1e-8, atol=1e-10)


def test_batched_obstacles():
    """Three-obstacle scenario through the batched path: solved + feasible."""
    B = 3
    defn = UnicycleProblem(scenario="three_obstacles")
    prob = defn.make_problem(add_constraints=True).compile()
    opts = SolverOptions(initial_penalty=10.0)
    params_b, Zb = _batchify(defn, prob, B, spread=0.02)
    fast = ALSolverBatched(prob, opts)
    x0_bl = jnp.moveaxis(params_b.x0, 0, -1)
    res = fast.solve(params_b.replace(x0=x0_bl), to_batch_last(Zb))
    assert np.all(np.asarray(res["status"]) == SolverStatus.SOLVED)
    assert np.asarray(res["stats"].violations).max() < opts.constraint_tolerance


def test_batched_stall_status_distinct_from_solved():
    """Unreachable gradient tolerance → SOLVED_STALLED per instance, and the
    AL outer loop propagates it (not plain SOLVED) on a stalled-but-feasible
    solve."""
    B = 3
    defn = UnicycleProblem()
    prob = defn.make_problem(add_constraints=True).compile()
    opts = SolverOptions(gradient_tolerance=0.0, max_stall_iterations=3)
    params_b, Zb = _batchify(defn, prob, B, spread=0.05)
    fast = ALSolverBatched(prob, opts)
    x0_bl = jnp.moveaxis(params_b.x0, 0, -1)
    res = fast.solve(params_b.replace(x0=x0_bl), to_batch_last(Zb))
    status = np.asarray(res["status"])
    assert not np.any(status == SolverStatus.SOLVED)
    assert np.all(
        np.isin(status, [SolverStatus.SOLVED_STALLED, SolverStatus.MAX_PENALTY])
    )
    # the per-instance path agrees on the status split
    ref = ALSolver(prob, opts)
    axes = ProblemParams(x0=0, dynamics=None, costs=None, constraints=None)
    res_ref = jax.vmap(ref.solve, in_axes=(axes, 0, None))(params_b, Zb, None)
    np.testing.assert_array_equal(status, np.asarray(res_ref.status))
