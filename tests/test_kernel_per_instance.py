"""Per-instance problem params on the fused Pallas kernels (r4).

BASELINE config 5 is a fleet of RANDOMIZED unicycle+obstacle problems:
per-instance obstacle layouts, goal references, and initial states.  The
reference's loop-of-solves is indifferent to which problem object each
iteration uses (`perf/benchmark_unicycle.cpp:45-75`); the r3 kernels were
not — any per-instance cost/constraint/dynamics param leaf fell back to the
slower XLA scans.  The kernels read per-instance leaves as lane vectors
(`ForwardKernel.param_sig`, specs per signature); these tests verify both
kernels against the batch-last scan oracles in interpret mode (f64, so
equality is algorithmic).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from altro_jax import SolverOptions, SolverStatus
from altro_jax.models.problems import UnicycleProblem
from altro_jax.ops.backward_fused_pallas import build_backward_fused_kernel
from altro_jax.ops.forward_pallas import Ineligible, build_forward_kernel
from altro_jax.solver.batched import ALSolverBatched, to_batch_last

TILE = 1024


def _randomized_fleet(N=10, seed=0, dtype=jnp.float64, vary_goal=True):
    """Three-obstacle problem with per-instance x0, obstacle layout, and
    (optionally) goal reference — the config-5 workload in miniature."""
    defn = UnicycleProblem(scenario="three_obstacles", dtype=dtype)
    defn.N = N
    defn.__post_init__()
    prob = defn.make_problem(add_constraints=True).compile()
    rng = np.random.default_rng(seed)
    params = prob.params

    # per-instance obstacle layouts: jitter the canonical three circles
    cx0, cy0, r0 = defn.obstacles
    cx = jnp.asarray(cx0[:, None] + rng.uniform(-0.2, 0.2, (3, TILE)), dtype)
    cy = jnp.asarray(cy0[:, None] + rng.uniform(-0.2, 0.2, (3, TILE)), dtype)
    rr = jnp.asarray(r0[:, None] * rng.uniform(0.8, 1.1, (3, TILE)), dtype)
    cons = list(params.constraints)
    ci = next(
        i for i, f in enumerate(prob.constraint_families)
        if f.constraint.structure[0] == "circle"
    )
    cons[ci] = dict(cons[ci], cx=cx, cy=cy, r=rr)

    costs = list(params.costs)
    if vary_goal:
        # per-instance goal: xf enters the goal constraint AND the tracking
        # cost's q/c (lqr_cost: q = -Q xf, c = ½ xfᵀQxf).  The compiler
        # merges the stage + terminal quadratic costs into ONE per-knot
        # stacked family (Q [nk,3,3]), so the per-instance refs are
        # per-knot AND per-instance — the layout the r4 kernels stream as
        # stage rows + terminal tile.
        xf = jnp.asarray(
            defn.xf[:, None] + rng.uniform(-0.3, 0.3, (3, TILE)), dtype
        )
        gi = next(
            i for i, f in enumerate(prob.constraint_families)
            if f.constraint.structure[0] == "goal"
        )
        cons[gi] = dict(cons[gi], xf=xf)
        cp0 = params.costs[0]
        Qstack = jnp.asarray(cp0["Q"], dtype)  # [nk, 3, 3]
        q = -jnp.einsum("kij,jb->kib", Qstack, xf)
        c = 0.5 * jnp.einsum("ib,kij,jb->kb", xf, Qstack, xf)
        costs[0] = dict(cp0, q=q, c=c)

    x0s = jnp.asarray(rng.uniform(-0.2, 0.2, (3, TILE)), dtype)
    params = params.replace(
        x0=x0s, constraints=tuple(cons), costs=tuple(costs)
    )
    Z0 = defn.initial_trajectory()
    Zb = to_batch_last(
        jax.tree_util.tree_map(
            lambda l: jnp.broadcast_to(l, (TILE,) + l.shape), Z0
        )
    )
    return defn, prob, params, Zb


@pytest.fixture(scope="module")
def fleet():
    return _randomized_fleet()


def test_param_sig_detects_per_instance_leaves(fleet):
    defn, prob, params, Zb = fleet
    kern = build_forward_kernel(
        prob, SolverOptions(), interpret=True, dtype=jnp.float64
    )
    assert kern.param_sig(prob.params) == frozenset()
    sig = kern.param_sig(params)
    # 3 circle leaves + goal xf + q/c on the (single, stacked) cost family
    assert any(s.startswith("con") and s.endswith("_cx") for s in sig)
    assert any(s.endswith("_xf") for s in sig)
    assert "cost0_q" in sig and "cost0_c" in sig
    assert len(sig) == 6


def test_forward_kernel_per_instance_matches_scan(fleet):
    """Closed-loop rollout + AL cost with per-instance params equals the
    two-scan oracle exactly (f64 interpret mode)."""
    defn, prob, params, Zb = fleet
    opts = SolverOptions()
    fast = ALSolverBatched(prob, opts)
    Zb = fast.rollout(params, Zb)
    rng = np.random.default_rng(7)
    al = tuple(
        dict(
            lam=jnp.asarray(rng.uniform(-0.5, 0.0, st["lam"].shape)),
            rho=jnp.asarray(rng.uniform(1.0, 10.0, st["rho"].shape)),
        )
        for st in fast.al_state_init(TILE, jnp.float64)
    )
    kern = build_forward_kernel(prob, opts, interpret=True, dtype=jnp.float64)
    exp = fast.expand(params, al, Zb)
    K, d, *_ = fast.riccati_scan(exp, jnp.zeros((TILE,)))
    alpha = jnp.full((TILE,), 0.5)

    Xn, Ubar, J, valid, status = kern(
        params, kern.pad_al(al), Zb, K, d, alpha, check_bounds=True
    )
    Z_ref, valid_ref, status_ref = fast.closed_loop_rollout(
        params, Zb, K, d, alpha
    )
    J_ref = fast.total_cost(params, al, Z_ref)
    np.testing.assert_allclose(Xn, Z_ref.X[1:], rtol=1e-11, atol=1e-12)
    np.testing.assert_allclose(Ubar, Z_ref.U, rtol=1e-11, atol=1e-12)
    np.testing.assert_allclose(J, J_ref, rtol=1e-9, atol=1e-11)
    np.testing.assert_array_equal(np.asarray(valid), np.asarray(valid_ref))


def test_backward_fused_per_instance_matches_expand_scan(fleet):
    defn, prob, params, Zb = fleet
    fast = ALSolverBatched(prob, SolverOptions())
    Zb = fast.rollout(params, Zb)
    rng = np.random.default_rng(9)
    al = tuple(
        dict(
            lam=jnp.asarray(rng.uniform(-0.5, 0.0, st["lam"].shape)),
            rho=jnp.asarray(rng.uniform(1.0, 10.0, st["rho"].shape)),
        )
        for st in fast.al_state_init(TILE, jnp.float64)
    )
    kern = build_backward_fused_kernel(
        prob, SolverOptions(), interpret=True, dtype=jnp.float64
    )
    rho = jnp.full((TILE,), 0.1)
    exp = fast.expand(params, al, Zb)
    K0, d0, dV10, dV20, f0 = fast.riccati_scan(exp, rho)
    J0r = fast.total_cost(params, al, Zb)
    K1, d1, dV11, dV21, f1, J01 = kern(params, kern.pad_al(al), Zb, rho)
    np.testing.assert_allclose(K1, K0, rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(d1, d0, rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(dV11, dV10, rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(dV21, dV20, rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(J01, J0r, rtol=1e-10)
    np.testing.assert_array_equal(np.asarray(f1), np.asarray(f0))


def test_full_solve_kernels_match_scans_per_instance(fleet):
    """Whole AL solve on the randomized fleet: kernel config (fused backward
    + pallas forward, interpret) reproduces the scan config's iteration path
    and solution instance-by-instance."""
    defn, prob, params, Zb = fleet
    opts = SolverOptions(initial_penalty=10.0)
    ref = ALSolverBatched(prob, opts)
    res_ref = jax.jit(ref.solve)(params, Zb)

    kopts = opts.replace(backward_pass="fused", forward_pass="pallas")
    fast = ALSolverBatched(prob, kopts)
    # tests run f64 on CPU: swap in interpret-mode f64 kernel builds
    fast._fwd = build_forward_kernel(prob, kopts, interpret=True, dtype=jnp.float64)
    fast._bwd = build_backward_fused_kernel(
        prob, kopts, interpret=True, dtype=jnp.float64
    )
    assert fast._fwd is not None and fast._bwd is not None
    assert fast._use_fwd(params, Zb) and fast._use_kernel(
        fast._bwd, params, Zb
    )
    res = jax.jit(fast.solve)(params, Zb)

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
    solved = np.asarray(res["status"]) == int(SolverStatus.SOLVED)
    assert solved.mean() > 0.95


def test_per_instance_dynamics_scalar():
    """A per-instance dynamics scalar (wheel-speed scale) is read as a lane
    vector; kernel rollout equals the scan rollout."""
    from altro_jax.problem.dynamics import ContinuousModel, discretize
    from altro_jax.problem.problem import Problem
    from altro_jax.problem.costs import lqr_cost

    def fn(params, x, u, t):
        del t
        s = params["scale"]
        return jnp.stack(
            [s * u[0] * jnp.cos(x[2]), s * u[0] * jnp.sin(x[2]), u[1]]
        )

    model = ContinuousModel(
        params={"scale": jnp.asarray(1.0)}, fn=fn, n=3, m=2, name="scaled_uni"
    )
    N = 8
    prob = Problem(N)
    prob.set_cost(lqr_cost(jnp.eye(3) * 0.1, jnp.eye(2) * 0.1, jnp.ones(3)), range(N))
    prob.set_cost(
        lqr_cost(jnp.eye(3) * 10.0, jnp.zeros((2, 2)), jnp.ones(3), terminal=True), N
    )
    prob.set_dynamics(discretize(model, "rk4"), range(N))
    prob.set_initial_state(jnp.zeros(3))
    cp = prob.compile()

    rng = np.random.default_rng(3)
    scale = jnp.asarray(rng.uniform(0.5, 1.5, (TILE,)))
    params = cp.params.replace(
        dynamics=(dict(cp.params.dynamics[0], scale=scale),),
        x0=jnp.asarray(rng.uniform(-0.1, 0.1, (3, TILE))),
    )
    from altro_jax.types import initial_trajectory

    Z0 = initial_trajectory(3, 2, N, 0.1, u0=np.full(2, 0.1), dtype=jnp.float64)
    Zb = to_batch_last(
        jax.tree_util.tree_map(
            lambda l: jnp.broadcast_to(l, (TILE,) + l.shape), Z0
        )
    )
    opts = SolverOptions()
    fast = ALSolverBatched(prob=cp, opts=opts)
    Zb = fast.rollout(params, Zb)
    kern = build_forward_kernel(cp, opts, interpret=True, dtype=jnp.float64)
    assert kern is not None
    assert "dyn0" in kern.param_sig(params)
    zK = jnp.zeros((N, 2, 3, TILE))
    zd = jnp.zeros((N, 2, TILE))
    Xn, Ubar, J, valid, status = kern(
        params, [], Zb, zK, zd, jnp.zeros((TILE,)), check_bounds=False
    )
    Z_ref = fast.rollout(params, Zb)
    J_ref = fast.total_cost(params, (), Z_ref)
    np.testing.assert_allclose(Xn, Z_ref.X[1:], rtol=1e-11, atol=1e-12)
    np.testing.assert_allclose(J, J_ref, rtol=1e-10, atol=1e-12)


def test_unstreamable_layout_falls_back(fleet):
    """Full-range per-knot + per-instance params stream (r4); a rank the
    signature convention doesn't cover raises Ineligible and the solver's
    kernel-eligibility gate routes the solve to the XLA scans."""
    defn, prob, params, Zb = fleet
    kern = build_forward_kernel(
        prob, SolverOptions(), interpret=True, dtype=jnp.float64
    )
    nk = len(prob.cost_families[0].knots)
    n = prob.n
    # [nk, n, n, B] vs canonical [nk, n, n]: per-knot AND per-instance on
    # the full knot range — streamable
    Qpk = jnp.broadcast_to(
        jnp.asarray(params.costs[0]["Q"])[..., None], (nk, n, n, TILE)
    )
    ok = params.replace(costs=(dict(params.costs[0], Q=Qpk),))
    assert "cost0_Q" in kern.param_sig(ok)
    # two extra axes is not a layout the convention covers
    bad = params.replace(
        costs=(dict(params.costs[0], q=jnp.zeros((nk, n, TILE, 1))),)
    )
    with pytest.raises(Ineligible):
        kern.param_sig(bad)
    solver = ALSolverBatched(
        prob, SolverOptions(forward_pass="pallas", backward_pass="fused")
    )
    assert not solver._use_fwd(bad, Zb)
    assert not solver._use_kernel(solver._bwd, bad, Zb)
