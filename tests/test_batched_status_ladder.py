"""Full status-ladder coverage through the batch-native solver.

The kernel-level guards are tested elsewhere (rollout divergence in
tests/test_forward_pallas.py, Cholesky give-up in tests/test_riccati.py);
these drive each failure code end-to-end through `ALSolverBatched.solve`
(reference semantics: `ilqr.hpp:484-494` limits, `ilqr.hpp:418-426`
regularization failure, `al_solver.hpp:388-399` caps).
"""
import jax
import jax.numpy as jnp
import numpy as np

from altro_jax import (
    Cost,
    Problem,
    SolverOptions,
    SolverStatus,
    initial_trajectory,
    lqr_cost,
)
from altro_jax.models.problems import UnicycleProblem
from altro_jax.models.unicycle import unicycle_rk4
from altro_jax.solver.batched import ALSolverBatched, to_batch_last


def _parking(B=4, N=30, **opt_kw):
    defn = UnicycleProblem()
    defn.N = N
    defn.__post_init__()
    prob = defn.make_problem(add_constraints=True).compile()
    Z0 = defn.initial_trajectory()
    Zb = to_batch_last(
        jax.tree_util.tree_map(
            lambda l: jnp.broadcast_to(l, (B,) + l.shape), Z0
        )
    )
    solver = ALSolverBatched(prob, SolverOptions(**opt_kw))
    return solver, prob, Zb


def test_state_limit_reported():
    """state_max below the goal distance: every line-search rollout trips
    the divergence guard, the search exhausts, STATE_LIMIT reported."""
    solver, prob, Zb = _parking(state_max=0.2)
    res = jax.jit(solver.solve)(prob.params, Zb)
    assert np.all(
        np.asarray(res["status"]) == int(SolverStatus.STATE_LIMIT)
    ), np.asarray(res["status"])


def test_control_limit_reported():
    """control_max below the feedforward magnitude the solve needs."""
    solver, prob, Zb = _parking(control_max=0.05)
    res = jax.jit(solver.solve)(prob.params, Zb)
    status = np.asarray(res["status"])
    assert np.all(status == int(SolverStatus.CONTROL_LIMIT)), status


def test_backward_pass_regularization_failed_reported():
    """Concave control cost with the regularization ceiling below the
    needed level: every sweep's Cholesky fails, the retry ladder gives up."""
    B, N, h = 4, 10, 0.1

    def bad_cost(params, x, u):
        return 0.5 * (x @ x) - 2.0 * (u @ u)  # luu = -4 I: never PD at rho<=1

    prob = Problem(N)
    prob.set_cost(Cost(params={}, fn=bad_cost), range(N))
    prob.set_cost(lqr_cost(jnp.eye(3), jnp.zeros((2, 2)), jnp.zeros(3),
                           jnp.zeros(2), terminal=True), N)
    prob.set_dynamics(unicycle_rk4(), range(N))
    prob.set_initial_state(jnp.asarray([0.1, 0.1, 0.0]))
    cp = prob.compile()
    solver = ALSolverBatched(
        cp,
        SolverOptions(bp_reg_max=1.0, bp_reg_fail_threshold=3),
    )
    Z0 = initial_trajectory(3, 2, N, h)
    Zb = to_batch_last(
        jax.tree_util.tree_map(
            lambda l: jnp.broadcast_to(l, (B,) + l.shape), Z0
        )
    )
    res = jax.jit(solver.solve)(cp.params, Zb)
    assert np.all(
        np.asarray(res["status"])
        == int(SolverStatus.BACKWARD_PASS_REGULARIZATION_FAILED)
    ), np.asarray(res["status"])


def test_max_outer_iterations_reported():
    """Outer cap of 1 with a goal constraint that needs several dual
    updates: the single outer iteration leaves viol > tol."""
    solver, prob, Zb = _parking(max_iterations_outer=1)
    res = jax.jit(solver.solve)(prob.params, Zb)
    status = np.asarray(res["status"])
    assert np.all(status == int(SolverStatus.MAX_OUTER_ITERATIONS)), status


def test_max_total_iterations_reported():
    solver, prob, Zb = _parking(max_iterations_total=3)
    res = jax.jit(solver.solve)(prob.params, Zb)
    status = np.asarray(res["status"])
    assert np.all(status == int(SolverStatus.MAX_ITERATIONS)), status


def test_stalled_feasible_exit_vs_escalation():
    """stalled_feasible_exits semantics (r4, VERDICT #4).

    Force a feasible-but-stalled inner solve: cost_tolerance huge (dJ is
    always below it, so the stall counter fires immediately) while
    gradient_tolerance is unreachable.  With the default True the outer
    loop exits SOLVED_STALLED on the first feasible check; with False it
    keeps escalating the penalty, and when the caps end it the label is
    still SOLVED_STALLED — never MAX_PENALTY/MAX_OUTER_ITERATIONS
    (`solver/batched.py` outer ladder).
    """
    kw = dict(
        cost_tolerance=1e9,
        gradient_tolerance=1e-30,
        constraint_tolerance=1e9,
        max_stall_iterations=2,
        max_iterations_outer=4,
    )
    solver, prob, Zb = _parking(**kw)
    res = jax.jit(solver.solve)(prob.params, Zb)
    status = np.asarray(res["status"])
    assert np.all(status == int(SolverStatus.SOLVED_STALLED)), status
    outer_true = np.asarray(res["stats"].iterations_outer)

    solver2, prob2, Zb2 = _parking(stalled_feasible_exits=False, **kw)
    res2 = jax.jit(solver2.solve)(prob2.params, Zb2)
    status2 = np.asarray(res2["status"])
    assert np.all(status2 == int(SolverStatus.SOLVED_STALLED)), status2
    outer_false = np.asarray(res2["stats"].iterations_outer)
    # the escalating config kept going past the first feasible check
    assert np.all(outer_false > outer_true), (outer_false, outer_true)
