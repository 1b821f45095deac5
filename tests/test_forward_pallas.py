"""Fused forward-pass Pallas kernel equivalence vs the XLA scan pair.

The kernel (`ops/forward_pallas.py`) fuses closed-loop rollout + total AL
cost into one kernel pass; these tests verify it in interpret mode
against the two-scan oracle (`solver/batched.py`: `closed_loop_rollout` +
`total_cost`), covering the open-loop (α=K=d=0) path, the divergence guard
(`ilqr.hpp:468-499` freeze semantics), terminal cost/constraint terms, and
the full solve with `forward_pass="pallas"`.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from altro_jax import SolverOptions, SolverStatus
from altro_jax.models.problems import TripleIntegratorProblem, UnicycleProblem
from altro_jax.ops.forward_pallas import ForwardKernel, build_forward_kernel
from altro_jax.solver.batched import ALSolverBatched, to_batch_last

B = ForwardKernel.__init__.__defaults__  # noqa: F841 (doc aid only)
TILE = 1024  # SUB * LANE


def _setup(N=12, constrained=True, dtype=jnp.float64, spread=0.3, seed=0,
           opts=None):
    defn = UnicycleProblem(dtype=dtype)
    defn.N = N
    defn.__post_init__()
    prob = defn.make_problem(add_constraints=constrained).compile()
    opts = opts or SolverOptions()
    fast = ALSolverBatched(prob, opts)
    Z0 = defn.initial_trajectory()
    rng = np.random.default_rng(seed)
    x0s = jnp.asarray(rng.uniform(-spread, spread, (3, TILE)), dtype)
    params = prob.params.replace(x0=x0s)
    Zb = to_batch_last(
        jax.tree_util.tree_map(
            lambda l: jnp.broadcast_to(l, (TILE,) + l.shape), Z0
        )
    )
    Zb = fast.rollout(params, Zb)
    al = fast.al_state_init(TILE, dtype)
    kern = build_forward_kernel(prob, opts, interpret=True, dtype=dtype)
    assert kern is not None
    return fast, prob, params, al, Zb, kern


@pytest.fixture(scope="module")
def setup():
    return _setup()


def _gains(fast, params, al, Zb, seed=1):
    exp = fast.expand(params, al, Zb)
    rho = jnp.zeros((TILE,), exp["A"].dtype)
    K, d, *_ = fast.riccati_scan(exp, rho)
    return K, d


@pytest.mark.parametrize("width", [3, 100])
def test_odd_width_pads_lanes(setup, width):
    """Closed-loop rollout + cost at a width that is not a multiple of the
    lanes per program: padded with copies of the last lane, sliced back,
    equal to the oracle pair lane for lane."""
    fast, prob, params, al, Zb, kern = setup
    assert width % kern.block_for(width)
    K, d = _gains(fast, params, al, Zb)
    sub = lambda a: a[..., :width]
    p = params.replace(x0=sub(params.x0))
    a = tuple(dict(lam=sub(s["lam"]), rho=sub(s["rho"])) for s in al)
    Z = Zb.replace(X=sub(Zb.X), U=sub(Zb.U))
    alpha = jnp.linspace(0.25, 1.0, width)
    Zbar, valid0, status0 = fast.closed_loop_rollout(p, Z, sub(K), sub(d), alpha)
    J0 = fast.total_cost(p, a, Zbar)
    Xn, Ubar, J, valid, status = kern(p, kern.pad_al(a), Z, sub(K), sub(d), alpha)
    assert Xn.shape == Zbar.X[1:].shape and J.shape == (width,)
    np.testing.assert_allclose(Xn, Zbar.X[1:], rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(Ubar, Zbar.U, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(J, J0, rtol=1e-10, atol=1e-12)
    np.testing.assert_array_equal(np.asarray(valid), np.asarray(valid0))
    np.testing.assert_array_equal(np.asarray(status), np.asarray(status0))


def test_open_loop_matches_rollout_plus_cost(setup):
    """α = K = d = 0 reduces the kernel to open-loop rollout + total cost."""
    fast, prob, params, al, Zb, kern = setup
    N, n, m = prob.N, prob.n, prob.m
    zK = jnp.zeros((N, m, n, TILE), Zb.X.dtype)
    zd = jnp.zeros((N, m, TILE), Zb.X.dtype)
    zal = jnp.zeros((TILE,), Zb.X.dtype)
    al_pad = kern.pad_al(al)
    Xn, Ubar, J, valid, status = kern(
        params, al_pad, Zb, zK, zd, zal, check_bounds=False
    )
    Z_ref = fast.rollout(params, Zb)
    J_ref = fast.total_cost(params, al, Z_ref)
    np.testing.assert_allclose(Xn, Z_ref.X[1:], rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(Ubar, Z_ref.U, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(J, J_ref, rtol=1e-10, atol=1e-12)
    assert bool(jnp.all(valid))
    assert np.all(np.asarray(status) == SolverStatus.UNSOLVED)


def test_closed_loop_matches_scan_pair(setup):
    """Full feedback rollout + AL cost vs the two-scan oracle, with warm
    duals/penalties so the AL terms are nontrivial."""
    fast, prob, params, al, Zb, kern = setup
    # warm the AL state: nonzero duals, mixed penalties
    rng = np.random.default_rng(7)
    al = tuple(
        dict(
            lam=jnp.asarray(
                rng.uniform(-0.5, 0.0, st["lam"].shape), st["lam"].dtype
            ),
            rho=jnp.asarray(
                rng.uniform(1.0, 10.0, st["rho"].shape), st["rho"].dtype
            ),
        )
        for st in al
    )
    K, d = _gains(fast, params, al, Zb)
    alpha = jnp.asarray(
        np.random.default_rng(3).uniform(0.1, 1.0, (TILE,)), Zb.X.dtype
    )
    al_pad = kern.pad_al(al)
    Xn, Ubar, J, valid, status = kern(
        params, al_pad, Zb, K, d, alpha, check_bounds=True
    )
    Z_ref, valid_ref, status_ref = fast.closed_loop_rollout(
        params, Zb, K, d, alpha
    )
    J_ref = fast.total_cost(params, al, Z_ref)
    np.testing.assert_allclose(Xn, Z_ref.X[1:], rtol=1e-11, atol=1e-12)
    np.testing.assert_allclose(Ubar, Z_ref.U, rtol=1e-11, atol=1e-12)
    np.testing.assert_allclose(J, J_ref, rtol=1e-9, atol=1e-11)
    np.testing.assert_array_equal(np.asarray(valid), np.asarray(valid_ref))
    np.testing.assert_array_equal(np.asarray(status), np.asarray(status_ref))


def test_divergence_guard_freeze_semantics():
    """A tight state_max trips the guard mid-horizon: the kernel must freeze
    the state, record STATE_LIMIT, and match the scan oracle exactly."""
    opts = SolverOptions(state_max=1.2)
    fast, prob, params, al, Zb, kern = _setup(spread=0.5, seed=4, opts=opts)
    N, n, m = prob.N, prob.n, prob.m
    # large feedforward pushes some instances over the state bound
    rng = np.random.default_rng(5)
    K = jnp.zeros((N, m, n, TILE), Zb.X.dtype)
    d = jnp.asarray(rng.uniform(0.5, 2.0, (N, m, TILE)), Zb.X.dtype)
    alpha = jnp.ones((TILE,), Zb.X.dtype)
    al_pad = kern.pad_al(al)
    Xn, Ubar, J, valid, status = kern(
        params, al_pad, Zb, K, d, alpha, check_bounds=True
    )
    Z_ref, valid_ref, status_ref = fast.closed_loop_rollout(
        params, Zb, K, d, alpha
    )
    st = np.asarray(status)
    assert (st == SolverStatus.STATE_LIMIT).any(), "guard never tripped"
    assert (~np.asarray(valid)).any()
    np.testing.assert_array_equal(np.asarray(valid), np.asarray(valid_ref))
    np.testing.assert_array_equal(st, np.asarray(status_ref))
    np.testing.assert_allclose(Xn, Z_ref.X[1:], rtol=1e-11, atol=1e-12)
    np.testing.assert_allclose(Ubar, Z_ref.U, rtol=1e-11, atol=1e-12)


def test_control_limit_status():
    """control_max guard reports CONTROL_LIMIT when only controls blow up."""
    opts = SolverOptions(control_max=1.0, state_max=1e8)
    fast, prob, params, al, Zb, kern = _setup(spread=0.1, seed=6, opts=opts)
    N, n, m = prob.N, prob.n, prob.m
    K = jnp.zeros((N, m, n, TILE), Zb.X.dtype)
    d = 5.0 * jnp.ones((N, m, TILE), Zb.X.dtype)
    alpha = jnp.ones((TILE,), Zb.X.dtype)
    al_pad = kern.pad_al(al)
    *_, valid, status = kern(params, al_pad, Zb, K, d, alpha, check_bounds=True)
    _, valid_ref, status_ref = fast.closed_loop_rollout(params, Zb, K, d, alpha)
    assert (np.asarray(status) == SolverStatus.CONTROL_LIMIT).any()
    np.testing.assert_array_equal(np.asarray(status), np.asarray(status_ref))
    np.testing.assert_array_equal(np.asarray(valid), np.asarray(valid_ref))


def test_unconstrained_terminal_cost_path():
    """No constraint families: the kernel is rollout + pure quadratic cost
    including the terminal family added in the last time block."""
    fast, prob, params, al, Zb, kern = _setup(constrained=False)
    assert al == ()
    N, n, m = prob.N, prob.n, prob.m
    K, d = _gains(fast, params, al, Zb)
    alpha = 0.5 * jnp.ones((TILE,), Zb.X.dtype)
    Xn, Ubar, J, valid, status = kern(
        params, kern.pad_al(al), Zb, K, d, alpha, check_bounds=True
    )
    Z_ref, *_ = fast.closed_loop_rollout(params, Zb, K, d, alpha)
    J_ref = fast.total_cost(params, al, Z_ref)
    np.testing.assert_allclose(J, J_ref, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(Xn, Z_ref.X[1:], rtol=1e-11, atol=1e-12)


def test_full_solve_with_pallas_forward_matches_scan():
    """End-to-end: ALSolverBatched with forward_pass="pallas" (interpret)
    reproduces the scan-forward solve instance-by-instance."""
    dtype = jnp.float64
    defn = UnicycleProblem(dtype=dtype)
    defn.N = 12
    defn.__post_init__()
    prob = defn.make_problem(add_constraints=True).compile()
    opts = SolverOptions()
    rng = np.random.default_rng(11)
    x0s = jnp.asarray(rng.uniform(-0.2, 0.2, (3, TILE)), dtype)
    params = prob.params.replace(x0=x0s)
    Z0 = defn.initial_trajectory()
    Zb = to_batch_last(
        jax.tree_util.tree_map(
            lambda l: jnp.broadcast_to(l, (TILE,) + l.shape), Z0
        )
    )

    ref = ALSolverBatched(prob, opts)
    res_ref = ref.solve(params, Zb)

    fast = ALSolverBatched(prob, opts.replace(forward_pass="pallas"))
    # swap in the interpret-mode kernel (tests run on CPU)
    fast._fwd = build_forward_kernel(
        prob, fast.opts, interpret=True, dtype=dtype
    )
    assert fast._fwd is not None
    res = fast.solve(params, Zb)

    np.testing.assert_array_equal(
        np.asarray(res["status"]), np.asarray(res_ref["status"])
    )
    np.testing.assert_array_equal(
        np.asarray(res["stats"].iterations_total),
        np.asarray(res_ref["stats"].iterations_total),
    )
    np.testing.assert_allclose(
        np.asarray(res["Z"].U), np.asarray(res_ref["Z"].U),
        rtol=1e-7, atol=1e-9,
    )
    np.testing.assert_allclose(
        np.asarray(res["stats"].cost), np.asarray(res_ref["stats"].cost),
        rtol=1e-9, atol=1e-12,
    )


def test_ineligible_problems_return_none():
    """Structures the kernel can't fuse must fall back (build → None)."""
    from altro_jax.problem.costs import Cost
    from altro_jax.problem.problem import Problem

    # SOC cones / opaque constraints are rejected upstream by ALSolverBatched;
    # here: a non-quadratic cost family is ineligible for the kernel.
    defn = TripleIntegratorProblem(dof=2)
    prob = defn.make_problem().compile()
    kern = build_forward_kernel(prob, SolverOptions(), interpret=True)
    # triple integrator is linear + quadratic cost: eligible
    assert kern is not None

    # a generic-cost problem is ineligible
    defn2 = UnicycleProblem()
    p2 = defn2.make_problem(add_constraints=False)
    generic = Cost(
        fn=lambda p, x, u: jnp.sum(x**4) + jnp.sum(u**2), params={}
    )
    p2.set_cost(generic, 0)
    kern2 = build_forward_kernel(p2.compile(), SolverOptions(), interpret=True)
    assert kern2 is None


def _solve_with_spec_width(S, dtype=jnp.float64, N=12, seed=11):
    defn = UnicycleProblem(dtype=dtype)
    defn.N = N
    defn.__post_init__()
    prob = defn.make_problem(add_constraints=True).compile()
    opts = SolverOptions(forward_pass="pallas", line_search_parallel=S)
    rng = np.random.default_rng(seed)
    x0s = jnp.asarray(rng.uniform(-0.2, 0.2, (3, TILE)), dtype)
    params = prob.params.replace(x0=x0s)
    Z0 = defn.initial_trajectory()
    Zb = to_batch_last(
        jax.tree_util.tree_map(
            lambda l: jnp.broadcast_to(l, (TILE,) + l.shape), Z0
        )
    )
    solver = ALSolverBatched(prob, opts)
    solver._fwd = build_forward_kernel(prob, opts, interpret=True, dtype=dtype)
    assert solver._fwd is not None
    return solver.solve(params, Zb)


def test_speculative_line_search_matches_sequential():
    """S candidate step sizes evaluated in one widened kernel call accept
    exactly the α the sequential halving sequence would — statuses,
    iteration counts, final α, and trajectories are identical."""
    res_seq = _solve_with_spec_width(1)
    res_spec = _solve_with_spec_width(8)
    np.testing.assert_array_equal(
        np.asarray(res_spec["status"]), np.asarray(res_seq["status"])
    )
    np.testing.assert_array_equal(
        np.asarray(res_spec["stats"].iterations_total),
        np.asarray(res_seq["stats"].iterations_total),
    )
    np.testing.assert_array_equal(
        np.asarray(res_spec["stats"].alpha), np.asarray(res_seq["stats"].alpha)
    )
    np.testing.assert_allclose(
        np.asarray(res_spec["Z"].U), np.asarray(res_seq["Z"].U),
        rtol=1e-12, atol=1e-14,
    )
    np.testing.assert_allclose(
        np.asarray(res_spec["stats"].cost), np.asarray(res_seq["stats"].cost),
        rtol=1e-12, atol=1e-14,
    )


def test_speculative_width_smaller_than_backtrack_depth():
    """S=2 forces multi-round speculation on instances that backtrack more
    than twice; the round-boundary α/iteration bookkeeping must still match
    the sequential sequence exactly."""
    res_seq = _solve_with_spec_width(1, seed=3)
    res_spec = _solve_with_spec_width(2, seed=3)
    np.testing.assert_array_equal(
        np.asarray(res_spec["status"]), np.asarray(res_seq["status"])
    )
    np.testing.assert_array_equal(
        np.asarray(res_spec["stats"].iterations_total),
        np.asarray(res_seq["stats"].iterations_total),
    )
    np.testing.assert_array_equal(
        np.asarray(res_spec["stats"].alpha), np.asarray(res_seq["stats"].alpha)
    )
    np.testing.assert_allclose(
        np.asarray(res_spec["Z"].U), np.asarray(res_seq["Z"].U),
        rtol=1e-12, atol=1e-14,
    )


def test_speculative_line_search_with_per_instance_params():
    """r5 regression: the speculative search must widen EVERY per-instance
    param leaf with the lanes (it previously tiled only x0, so batched
    obstacle layouts / goal refs hit a reshape error in the kernel)."""
    dtype = jnp.float64
    defn = UnicycleProblem(scenario="three_obstacles", dtype=dtype)
    defn.N = 12
    defn.__post_init__()
    prob = defn.make_problem(add_constraints=True).compile()
    rng = np.random.default_rng(3)
    cx0, cy0, r0 = defn.obstacles
    ci = next(
        i for i, f in enumerate(prob.constraint_families)
        if f.constraint.structure[0] == "circle"
    )
    cons = list(prob.params.constraints)
    cons[ci] = dict(
        cons[ci],
        cx=jnp.asarray(cx0[:, None] + rng.uniform(-0.1, 0.1, (3, TILE)), dtype),
        cy=jnp.asarray(cy0[:, None] + rng.uniform(-0.1, 0.1, (3, TILE)), dtype),
    )
    params = prob.params.replace(
        x0=jnp.asarray(rng.uniform(-0.1, 0.1, (3, TILE)), dtype),
        constraints=tuple(cons),
    )
    Z0 = defn.initial_trajectory()
    Zb = to_batch_last(
        jax.tree_util.tree_map(
            lambda l: jnp.broadcast_to(l, (TILE,) + l.shape), Z0
        )
    )

    def solve(S):
        opts = SolverOptions(
            forward_pass="pallas", line_search_parallel=S,
            initial_penalty=10.0,
        )
        solver = ALSolverBatched(prob, opts)
        solver._fwd = build_forward_kernel(
            prob, opts, interpret=True, dtype=dtype
        )
        assert solver._fwd is not None
        assert solver._use_fwd(params, Zb)
        return solver.solve(params, Zb)

    res_seq = solve(1)
    res_spec = solve(4)
    np.testing.assert_array_equal(
        np.asarray(res_spec["status"]), np.asarray(res_seq["status"])
    )
    np.testing.assert_allclose(
        np.asarray(res_spec["Z"].U), np.asarray(res_seq["Z"].U),
        rtol=1e-12, atol=1e-14,
    )
