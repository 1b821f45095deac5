"""Batch-native solver generality: per-instance problem data beyond x0.

The reference handles heterogeneous scenarios by looping distinct problem
objects through one solver (`perf/benchmark_unicycle.cpp:45-75`).  The
batch-native solver's equivalent is param leaves carrying a trailing batch
axis (`solver/batched.py:batch_axes`): varied goals, obstacle layouts, and
physical model parameters all solve in one lockstep batch and must match the
vmap-of-general-solver path element-by-element.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from altro_jax import (
    ALSolver,
    Problem,
    ProblemParams,
    SolverOptions,
    SolverStatus,
    control_bound,
    goal_constraint,
    initial_trajectory,
    lqr_cost,
)
from altro_jax.models.cartpole import cartpole_rk4
from altro_jax.models.problems import TripleIntegratorProblem, UnicycleProblem
from altro_jax.solver.batched import (
    ALSolverBatched,
    any_batched,
    batch_axes,
    from_batch_last,
    to_batch_last,
)


def _stack(params_list, axis):
    """Stack per-instance ProblemParams: axis=0 (vmap) or -1 (batch-last)."""
    return jax.tree_util.tree_map(
        lambda *ls: jnp.stack(ls, axis=axis), *params_list
    )


def _broadcast_Z(Z0, B):
    return jax.tree_util.tree_map(
        lambda leaf: jnp.broadcast_to(leaf, (B,) + leaf.shape), Z0
    )


def _assert_matches_vmap(prob, opts, params_list, Z0, B, rtol=1e-8, atol=1e-10):
    """Batch-native with trailing-batch params == vmap of the general solver."""
    params_lead = _stack(params_list, 0)
    params_last = _stack(params_list, -1)
    Zb = _broadcast_Z(Z0, B)

    ref = ALSolver(prob, opts)
    res_ref = jax.vmap(ref.solve, in_axes=(0, 0, None))(params_lead, Zb, None)

    fast = ALSolverBatched(prob, opts)
    res_b = fast.solve(params_last, to_batch_last(Zb))
    Zf = from_batch_last(res_b["Z"])

    np.testing.assert_array_equal(
        np.asarray(res_b["status"]), np.asarray(res_ref.status)
    )
    np.testing.assert_array_equal(
        np.asarray(res_b["stats"].iterations_total),
        np.asarray(res_ref.stats.iterations_total),
    )
    np.testing.assert_allclose(Zf.U, res_ref.Z.U, rtol=rtol, atol=atol)
    return res_b, res_ref


def test_per_instance_goals_match_vmap():
    """Varied parking goals: per-instance cost refs AND goal-constraint
    targets (stage cost, terminal cost, and goal constraint all vary)."""
    B = 4
    defn = TripleIntegratorProblem(dof=2)
    base = defn.make_problem(add_constraints=True).compile()
    rng = np.random.default_rng(3)
    params_list = []
    for i in range(B):
        d = TripleIntegratorProblem(dof=2)
        d.xf = defn.xf + rng.uniform(-0.3, 0.3, size=defn.n)
        p = d.make_problem(add_constraints=True).compile().params
        params_list.append(p)
    res_b, _ = _assert_matches_vmap(
        base, SolverOptions(), params_list, defn.initial_trajectory(), B
    )
    assert np.all(np.asarray(res_b["status"]) == SolverStatus.SOLVED)
    # each instance parked at ITS goal (terminal equality constraint)
    Xf = np.asarray(res_b["Z"].X[-1])  # [n, B]
    for i, p in enumerate(params_list):
        goal = np.asarray(
            jax.tree_util.tree_leaves(p.constraints[-1])[0]
        )  # xf leaf
        np.testing.assert_allclose(Xf[:, i], goal, atol=1e-3)


def test_per_instance_obstacles_match_vmap():
    """Varied obstacle layouts across the batch (circle centers/radii)."""
    B = 3
    defn = UnicycleProblem(scenario="three_obstacles")
    base = defn.make_problem(add_constraints=True).compile()
    rng = np.random.default_rng(7)
    params_list = []
    for i in range(B):
        d = UnicycleProblem(scenario="three_obstacles")
        cx, cy, r = d.obstacles
        d.obstacles = (
            cx + rng.uniform(-0.02, 0.02, size=cx.shape),
            cy + rng.uniform(-0.02, 0.02, size=cy.shape),
            r * (1.0 + rng.uniform(-0.02, 0.02, size=r.shape)),
        )
        params_list.append(d.make_problem(add_constraints=True).compile().params)
    opts = SolverOptions(initial_penalty=10.0)
    res_b, _ = _assert_matches_vmap(
        base, opts, params_list, defn.initial_trajectory(), B
    )
    # constraint-satisfied end states (SOLVED, or stalled-at-floor but
    # feasible — the vmap path agrees exactly per _assert_matches_vmap)
    status = np.asarray(res_b["status"])
    assert np.all(
        (status == SolverStatus.SOLVED) | (status == SolverStatus.SOLVED_STALLED)
    )
    # feasibility against each instance's OWN obstacles
    X = np.asarray(res_b["Z"].X)  # [N+1, n, B]
    for i, p in enumerate(params_list):
        leaves = {
            k: np.asarray(v)
            for fam_p in p.constraints
            if isinstance(fam_p, dict) and "cx" in fam_p
            for k, v in fam_p.items()
        }
        d2 = (
            (X[:, 0, i][:, None] - leaves["cx"][None]) ** 2
            + (X[:, 1, i][:, None] - leaves["cy"][None]) ** 2
        )
        assert (np.sqrt(d2) - leaves["r"][None]).min() > -1e-3


def test_per_instance_dynamics_params_match_vmap():
    """Varied physical model parameters (cartpole pole mass) per instance."""
    B = 3
    N, h = 30, 0.05
    xf = jnp.array([0.0, jnp.pi, 0.0, 0.0])
    x0 = jnp.array([0.0, jnp.pi - 0.25, 0.0, 0.0])
    Q = jnp.eye(4) * 0.1 * h
    R = jnp.eye(1) * 0.01 * h
    Qf = jnp.eye(4) * 100.0

    def make(mass_pole):
        prob = Problem(N)
        prob.set_dynamics(cartpole_rk4(mass_pole=mass_pole), range(N))
        prob.set_cost(lqr_cost(Q, R, xf), range(N))
        prob.set_cost(lqr_cost(Qf, jnp.zeros((1, 1)), xf, terminal=True), N)
        prob.set_initial_state(x0)
        return prob.compile()

    base = make(0.3)
    params_list = [make(m).params for m in (0.25, 0.3, 0.4)]
    Z0 = initial_trajectory(4, 1, N, h)
    # looser gradient tolerance (the underactuated swing plateaus near
    # grad≈0.01) and looser control tolerance (rounding-sensitive dynamics);
    # iteration paths and statuses still match the vmap path exactly
    opts = SolverOptions(gradient_tolerance=0.05)
    res_b, _ = _assert_matches_vmap(
        base, opts, params_list, Z0, B, rtol=1e-4, atol=1e-5
    )
    assert np.all(np.asarray(res_b["status"]) == SolverStatus.SOLVED)
    # heavier pole ≠ lighter pole: the per-instance params actually bite
    U = np.asarray(res_b["Z"].U)
    assert np.abs(U[..., 0] - U[..., 2]).max() > 1e-4


def test_compaction_with_per_instance_params():
    """CompactedALSolver gathers per-instance param leaves when compacting
    stragglers."""
    from altro_jax.solver.compaction import CompactedALSolver

    B = 6
    defn = TripleIntegratorProblem(dof=2)
    base = defn.make_problem(add_constraints=True).compile()
    rng = np.random.default_rng(11)
    params_list = []
    for i in range(B):
        d = TripleIntegratorProblem(dof=2)
        d.xf = defn.xf + rng.uniform(-0.3, 0.3, size=defn.n)
        params_list.append(d.make_problem(add_constraints=True).compile().params)
    params_last = _stack(params_list, -1)
    Zb = to_batch_last(_broadcast_Z(defn.initial_trajectory(), B))

    full = ALSolverBatched(base, SolverOptions()).solve(params_last, Zb)
    comp = CompactedALSolver(
        base, SolverOptions(), phase1_iters=3, tail_batch=2
    ).solve(params_last, Zb)
    np.testing.assert_array_equal(
        np.asarray(comp["status"]), np.asarray(full["status"])
    )
    np.testing.assert_allclose(
        np.asarray(comp["Z"].U), np.asarray(full["Z"].U), rtol=1e-6, atol=1e-8
    )


def test_batch_axes_spec():
    """batch_axes marks exactly the trailing-batch leaves."""
    canon = {"a": jnp.zeros((3, 3)), "b": jnp.zeros(2), "c": jnp.zeros(())}
    actual = {
        "a": jnp.zeros((3, 3, 8)),
        "b": jnp.zeros(2),
        "c": jnp.zeros((8,)),
    }
    axes = batch_axes(canon, actual)
    assert axes == {"a": -1, "b": None, "c": -1}
    assert any_batched(canon, actual)
    assert not any_batched(canon, canon)


def test_pallas_request_falls_back_on_batched_params():
    """forward_pass='pallas' + per-instance cost params must not break: the
    eligibility gate routes to the scan path."""
    B = 2
    defn = TripleIntegratorProblem(dof=2)
    base = defn.make_problem(add_constraints=True).compile()
    params_list = []
    for dxf in (0.0, 0.1):
        d = TripleIntegratorProblem(dof=2)
        d.xf = defn.xf + dxf
        params_list.append(d.make_problem(add_constraints=True).compile().params)
    params_last = _stack(params_list, -1)
    Zb = to_batch_last(_broadcast_Z(defn.initial_trajectory(), B))
    solver = ALSolverBatched(base, SolverOptions(forward_pass="pallas"))
    assert not solver._use_fwd(params_last, Zb)
    res = solver.solve(params_last, Zb)
    assert np.all(np.asarray(res["status"]) == SolverStatus.SOLVED)
