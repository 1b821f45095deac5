"""Per-iteration statistics history in the batched solver.

The reference records per-iteration vectors (cost, alpha, gradient, reg,
viol, pen — `altro/common/solver_stats.hpp:54-61`).  `BatchedStats.rows`
([capacity, 8, B], gated by `SolverOptions.iteration_history_capacity`) is
the batched analog and must reproduce the per-instance `SolverStats.rows`
column-by-column for every instance.
"""
import jax
import jax.numpy as jnp
import numpy as np

from altro_jax import ALSolver, ProblemParams, SolverOptions, SolverStatus
from altro_jax.models.problems import UnicycleProblem
from altro_jax.solver.batched import (
    ALSolverBatched,
    _HISTORY_COLUMNS,
    batched_stats_column,
    to_batch_last,
)
from altro_jax.solver.compaction import CompactedALSolver
from altro_jax.types import _COLUMNS, stats_column


def _fleet(B, N=30, seed=0, spread=0.3):
    defn = UnicycleProblem()
    defn.N = N
    defn.__post_init__()
    prob = defn.make_problem(add_constraints=True).compile()
    rng = np.random.default_rng(seed)
    x0s = jnp.asarray(rng.uniform(-spread, spread, size=(3, B)))
    params_b = prob.params.replace(x0=x0s)
    Z0 = defn.initial_trajectory()
    Zb = to_batch_last(
        jax.tree_util.tree_map(
            lambda leaf: jnp.broadcast_to(leaf, (B,) + leaf.shape), Z0
        )
    )
    return prob, params_b, Zb


def test_history_columns_match_per_instance_stats():
    """Every history column equals the per-instance solver's stats rows."""
    assert _HISTORY_COLUMNS == _COLUMNS
    B = 4
    prob, params_b, Zb = _fleet(B)
    opts = SolverOptions(iteration_history_capacity=304)

    batched = ALSolverBatched(prob, opts)
    res_b = jax.jit(batched.solve)(params_b, Zb)

    # per-instance reference: vmap over the batch-leading layout
    from altro_jax.solver.batched import from_batch_last

    ref = ALSolver(prob, SolverOptions())
    axes = ProblemParams(x0=0, dynamics=None, costs=None, constraints=None)
    res_ref = jax.vmap(ref.solve, in_axes=(axes, 0, None))(
        params_b.replace(x0=jnp.moveaxis(params_b.x0, -1, 0)),
        from_batch_last(Zb),
        None,
    )

    np.testing.assert_array_equal(
        np.asarray(res_b["status"]), np.asarray(res_ref.status)
    )
    totals = np.asarray(res_b["stats"].iterations_total)
    np.testing.assert_array_equal(
        totals, np.asarray(res_ref.stats.iterations_total)
    )
    rows_ref = np.asarray(res_ref.stats.rows)  # [B, cap, 8]
    for name in _COLUMNS:
        col_b = np.asarray(batched_stats_column(res_b["stats"], name))  # [cap, B]
        ci = _COLUMNS.index(name)
        for b in range(B):
            T = int(totals[b])
            np.testing.assert_allclose(
                col_b[:T, b],
                rows_ref[b, :T, ci],
                rtol=1e-6,
                atol=1e-9,
                err_msg=f"column {name}, instance {b}",
            )


def test_history_disabled_costs_nothing():
    """Default capacity 0: rows is empty and results are unchanged."""
    B = 3
    prob, params_b, Zb = _fleet(B)
    res0 = jax.jit(ALSolverBatched(prob, SolverOptions()).solve)(params_b, Zb)
    assert res0["stats"].rows.shape[0] == 0
    res1 = jax.jit(
        ALSolverBatched(
            prob, SolverOptions(iteration_history_capacity=64)
        ).solve
    )(params_b, Zb)
    np.testing.assert_array_equal(
        np.asarray(res0["status"]), np.asarray(res1["status"])
    )
    np.testing.assert_allclose(
        np.asarray(res0["Z"].U), np.asarray(res1["Z"].U), rtol=1e-12
    )


def test_history_through_compaction_splice():
    """Tail rounds splice their history after each straggler's phase-1 rows."""
    B = 16
    prob, params_b, Zb = _fleet(B, spread=0.4)
    opts = SolverOptions(iteration_history_capacity=304)
    comp = CompactedALSolver(prob, opts, phase1_iters=6, tail_batch=5)
    res = comp.solve(params_b, Zb)
    status = np.asarray(res["status"])
    assert np.all(
        (status == SolverStatus.SOLVED)
        | (status == SolverStatus.SOLVED_STALLED)
    )
    totals = np.asarray(res["stats"].iterations_total)
    assert totals.max() > 6  # stragglers actually took tail rounds
    cost_col = np.asarray(batched_stats_column(res["stats"], "cost"))
    grad_col = np.asarray(batched_stats_column(res["stats"], "gradient"))
    final_cost = np.asarray(res["stats"].cost)
    final_grad = np.asarray(res["stats"].gradient)
    for b in range(B):
        T = int(totals[b])
        # last recorded row == final scalars (splice landed at the right rows)
        np.testing.assert_allclose(cost_col[T - 1, b], final_cost[b], rtol=1e-6)
        np.testing.assert_allclose(grad_col[T - 1, b], final_grad[b], rtol=1e-6)
        # recorded rows are populated, rows beyond T untouched (zero)
        assert np.all(cost_col[1:T, b] != 0.0)
        assert np.all(cost_col[T:, b] == 0.0)
    # the iteration-count distribution that tunes phase1_iters is recorded
    assert comp.telemetry["iters_p99"] >= comp.telemetry["iters_p50"]
