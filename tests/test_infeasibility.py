"""Structural infeasibility certificates (r5, VERDICT r4 ask #6).

A randomized sampler can emit layouts whose constraints provably conflict
(goal inside an obstacle).  `problem/infeasibility.py` certifies those
per instance; `CompactedALSolver(detect_infeasible=True)` reports them as
`SolverStatus.INFEASIBLE` without iterating, so fleet solved%% measures
the solver rather than the sampler.
"""
import jax
import jax.numpy as jnp
import numpy as np

from altro_jax import (
    Problem,
    SolverOptions,
    SolverStatus,
    circle_constraint,
    control_bound,
    goal_constraint,
    lqr_cost,
)
from altro_jax.models.unicycle import unicycle_rk4
from altro_jax.problem.infeasibility import goal_obstacle_certificates
from altro_jax.solver.batched import to_batch_last
from altro_jax.solver.compaction import CompactedALSolver
from altro_jax.types import initial_trajectory


def _prob(N=30, tf=1.5):
    n, m = 3, 2
    h = tf / N
    xf = jnp.array([1.0, 1.0, 0.0])
    prob = Problem(N=N)
    prob.set_initial_state(jnp.zeros(n))
    prob.set_dynamics(unicycle_rk4(), range(N))
    prob.set_cost(lqr_cost(jnp.eye(n) * 1e-2 * h, jnp.eye(m) * 1e-2 * h,
                           xf, jnp.zeros(m)), range(N))
    prob.set_cost(lqr_cost(jnp.eye(n) * 100.0, jnp.zeros((m, m)), xf,
                           jnp.zeros(m), terminal=True), N)
    prob.set_constraint(control_bound([-1.5, -1.5], [1.5, 1.5]), range(N))
    # obstacle constrained through the TERMINAL knot: goal-in-obstacle is
    # then directly contradictory (the same-knot certificate)
    prob.set_constraint(
        circle_constraint([0.5], [0.5], [0.2]), range(1, N + 1)
    )
    prob.set_constraint(goal_constraint(xf), N)
    return prob.compile(), xf, h


def test_certificate_flags_goal_in_obstacle():
    cp, xf, h = _prob()
    B = 8
    # per-instance goals: instance 3's goal sits INSIDE the obstacle
    xfs = np.tile(np.asarray(xf)[:, None], (1, B))
    xfs[:2, 3] = [0.55, 0.5]
    gi = next(
        i for i, f in enumerate(cp.constraint_families)
        if f.constraint.structure[0] == "goal"
    )
    cons = list(cp.params.constraints)
    cons[gi] = dict(cons[gi], xf=jnp.asarray(xfs))
    params = cp.params.replace(constraints=tuple(cons))
    mask = np.asarray(goal_obstacle_certificates(cp, params, B))
    np.testing.assert_array_equal(
        mask, [False, False, False, True, False, False, False, False]
    )


def test_compacted_solver_reports_infeasible():
    cp, xf, h = _prob()
    B = 8
    xfs = np.tile(np.asarray(xf)[:, None], (1, B))
    xfs[:2, 3] = [0.55, 0.5]
    gi = next(
        i for i, f in enumerate(cp.constraint_families)
        if f.constraint.structure[0] == "goal"
    )
    cons = list(cp.params.constraints)
    cons[gi] = dict(cons[gi], xf=jnp.asarray(xfs))
    params = cp.params.replace(constraints=tuple(cons))
    Z0 = initial_trajectory(3, 2, cp.N, h, u0=jnp.array([0.1, 0.0]))
    Zb = to_batch_last(
        jax.tree_util.tree_map(
            lambda l: jnp.broadcast_to(l, (B,) + l.shape), Z0
        )
    )
    opts = SolverOptions(
        backward_pass="scan", forward_pass="scan", initial_penalty=1.0,
        line_search_max_iterations=20, max_stall_iterations=10,
    )
    solver = CompactedALSolver(
        cp, opts, phase1_iters=10, tail_batch=8, device_tail=True,
        detect_infeasible=True,
    )
    res = solver.solve(params, Zb)
    st = np.asarray(res["status"])
    assert st[3] == int(SolverStatus.INFEASIBLE)
    assert np.all(st[np.arange(B) != 3] == int(SolverStatus.SOLVED))
    # certified lane spent zero iterations
    assert int(np.asarray(res["stats"].iterations_total)[3]) == 0
