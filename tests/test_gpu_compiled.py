"""Compiled-on-GPU kernel and full-solve verification.

The CPU suite runs the Pallas kernels in interpret mode
(tests/test_forward_pallas.py, tests/test_backward_fused.py); these tests
run the COMPILED Triton kernels — the execution path behind every timed
solve — on the card, plus full solves at the shipped config with control
parity vs the f64 reference golden.

Marked `gpu`; the `gpu` fixture skips them without a GPU.  On the GPU host:
    ALTRO_GPU_TESTS=1 python -m pytest -m gpu tests/test_gpu_compiled.py -q
(`chip_smoke.py` runs them in its own process.)
"""
import os
import sys

import numpy as np
import pytest

import jax

pytestmark = pytest.mark.gpu

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


@pytest.fixture(scope="module")
def parking(gpu):
    import jax.numpy as jnp

    from altro_jax.models.problems import UnicycleProblem

    defn = UnicycleProblem(dtype=jnp.float32)
    prob = defn.make_problem(add_constraints=True).compile()
    return defn, prob


def test_compiled_kernels_match_scan_oracles(parking):
    from perf.verify_kernels import verify_compiled_kernels

    defn, prob = parking
    deltas = verify_compiled_kernels(prob, defn, batch=1024)
    assert deltas["bwd_triton_call"] and deltas["fwd_triton_call"]


def test_full_solve_shipped_config_parity(parking):
    """One full compacted solve at the EXACT bench config: every status
    accounted for, and the canonical lane's controls within the stopping
    ball of the f64 reference solve at the same (reference-default)
    tolerances.  The 1e-4 contract is checked at the reference's test
    tolerances in the next test (see PARITY.md)."""
    import bench

    from altro_jax import SolverStatus

    defn, prob = parking
    import jax.numpy as jnp

    batch = 1024
    solver = bench.make_solver(prob, batch)
    params_b, Zb = bench.make_batch(prob, defn, batch, jnp.float32)
    res = solver.solve(params_b, Zb)
    status = np.asarray(res["status"])
    hist = bench.status_histogram(status)
    assert sum(hist.values()) == batch, hist
    assert hist.get(SolverStatus.SOLVED.name, 0) >= int(0.99 * batch), hist

    U_ref, X_ref, J_ref = bench.load_reference_golden()
    U0 = np.asarray(res["Z"].U[..., 0], np.float64)
    control_parity = float(np.abs(U0 - U_ref).max())
    # cost_tolerance = constraint_tolerance = 1e-4 stop the solve anywhere
    # in a ball of controls several 1e-4 wide (the reference's own endpoint
    # moves 1.02e-4 between its default and test tolerances, PARITY.md);
    # 7e-4 bounds that ball and still rejects a wrong or unconverged lane
    assert control_parity <= 7e-4, control_parity


def test_parity_metric_at_reference_test_config(parking):
    """The driver metric (control parity ≤ 1e-4, BASELINE.md:28), measured
    the way `bench.py` reports it: shipped kernels, f32, the reference's
    test config (constraint_tolerance=1e-6, `auglag_test.cpp:337`) vs the
    f64 solve of the same config — the config whose J the reference pins
    to 1e-17 (`auglag_test.cpp:346-349`).

    The solver's reported J (`stats.cost`) is its f32 AL merit.  It is held
    to 1e-4 of the reference J plus one unit roundoff of the merit's scale
    (`perf/verify_kernels.merit_f64`): near the goal the expanded quadratic's
    ½xᵀQx, qᵀx and c are each ≈ 350 at the terminal knot and cancel to
    J ≈ 0.039, so rounding the parameters to f32 alone moves the merit by
    −8.9e-5 of J and each f32 evaluation by up to ~0.4 u·scale (PERF.md).
    The objective of the returned trajectory, evaluated in f64, is held to
    the plain 1e-4."""
    import jax.numpy as jnp

    import bench
    from altro_jax import SolverStatus
    from altro_jax.solver.batched import ALSolverBatched
    from perf.verify_kernels import merit_f64

    defn, prob = parking
    batch = 1024
    res, _ = bench.parity_solve(prob, defn, batch=batch)
    assert int(np.asarray(res["status"][0])) == int(SolverStatus.SOLVED)
    U_ref, X_ref, J_ref = bench.load_reference_golden(
        "unicycle_turn90_refsolve_f64_tol6.npz"
    )
    U0 = np.asarray(res["Z"].U[..., 0], np.float64)
    X0 = np.asarray(res["Z"].X[..., 0], np.float64)
    assert float(np.abs(U0 - U_ref).max()) <= 1e-4
    assert float(np.abs(X0 - X_ref).max()) <= 1e-4
    solver = ALSolverBatched(prob, bench.parity_options())
    params = prob.params.replace(x0=jnp.zeros((prob.n, batch), jnp.float32))
    _, scale = merit_f64(solver, params, res["al"], res["Z"])
    u = float(np.finfo(np.float32).eps) / 2
    J0 = float(np.asarray(res["stats"].cost[0], np.float64))
    assert abs(J0 - J_ref) <= 1e-4 * J_ref + u * float(scale[0]), (J0, J_ref)
    assert abs(_objective(defn, X0, U0) - J_ref) / J_ref <= 1e-4


def _objective(defn, X, U):
    """The parking problem's quadratic objective (stage + terminal LQR
    costs, `UnicycleProblem.make_problem`) of one trajectory, in f64."""
    dx = X - np.asarray(defn.xf)[None]
    Q = np.asarray(defn.Q, np.float64)
    R = np.asarray(defn.R, np.float64)
    Qf = np.asarray(defn.Qf, np.float64)
    stage = 0.5 * np.einsum("ki,ij,kj->", dx[:-1], Q, dx[:-1])
    stage += 0.5 * np.einsum("ki,ij,kj->", U, R, U)
    return float(stage + 0.5 * dx[-1] @ Qf @ dx[-1])


def test_compiled_per_instance_kernels_match_scans(gpu):
    """r4: per-instance obstacle layouts / goal refs / cost refs read as
    lane vectors by the COMPILED kernels on the card — the config-5
    randomized-fleet path (`perf/benchmark_randomized.py` asserts
    engagement; this asserts numerics vs the XLA scan config on-device)."""
    import jax.numpy as jnp

    from altro_jax import SolverOptions, SolverStatus
    from altro_jax.models.problems import UnicycleProblem
    from altro_jax.solver.batched import ALSolverBatched, to_batch_last
    from perf.benchmark_randomized import make_randomized_fleet

    batch = 1024
    defn = UnicycleProblem(scenario="three_obstacles", dtype=jnp.float32)
    prob = defn.make_problem(add_constraints=True).compile()
    params, Zb, _, _ = make_randomized_fleet(prob, defn, batch, jnp.float32)
    opts = SolverOptions(
        initial_penalty=1.0, line_search_max_iterations=20,
        max_stall_iterations=10, scan_unroll=4,
        backward_pass="fused", forward_pass="pallas",
    )
    fast = ALSolverBatched(prob, opts)
    assert fast._use_fwd(params, Zb) and fast._use_kernel(fast._bwd, params, Zb)
    sig = fast._fwd.param_sig(params)
    assert len(sig) >= 6, sig
    res = jax.jit(fast.solve)(params, Zb)
    scan = ALSolverBatched(prob, opts.replace(
        backward_pass="scan", forward_pass="scan"
    ))
    res_s = jax.jit(scan.solve)(params, Zb)
    st_k = np.asarray(res["status"])
    st_s = np.asarray(res_s["status"])
    # the randomized obstacle scenario has an f32-borderline residue (about
    # a quarter of the lanes) whose statuses flip between ANY two f32
    # arithmetic orders, and some solved instances take different homotopy
    # routes around obstacles (a local method) — so the contract is robust
    # statistics, not per-instance equality: 70% status agreement, solved
    # counts within 5% of the batch, and the jointly solved lanes' controls
    # within 5e-2 at the 99th percentile (a different route moves them by
    # O(1), a shared one by the stopping ball):
    agree = float((st_k == st_s).mean())
    assert agree >= 0.7, agree
    n_k = int((st_k == int(SolverStatus.SOLVED)).sum())
    n_s = int((st_s == int(SolverStatus.SOLVED)).sum())
    assert abs(n_k - n_s) <= int(0.05 * batch), (n_k, n_s)
    both = (st_k == int(SolverStatus.SOLVED)) & (st_s == int(SolverStatus.SOLVED))
    dU = np.abs(
        np.asarray(res["Z"].U)[..., both] - np.asarray(res_s["Z"].U)[..., both]
    )
    assert float(np.percentile(dU, 99)) <= 5e-2, np.percentile(dU, 99)


def test_compiled_per_instance_goals_parking(gpu):
    """r4: per-instance goal refs (constraint xf + stacked cost q/c) on the
    well-conditioned parking scenario: compiled kernels vs the scan config
    agree nearly instance-for-instance.  Bounds: 98% status agreement and
    98% SOLVED (the rare disagreements are f32-borderline instances or
    alternate local minima), jointly solved controls within 2e-2 at the
    99th percentile (a few stopping-ball widths)."""
    import jax.numpy as jnp

    from altro_jax import SolverOptions, SolverStatus
    from altro_jax.models.problems import UnicycleProblem
    from altro_jax.solver.batched import ALSolverBatched, to_batch_last

    batch = 1024
    defn = UnicycleProblem(dtype=jnp.float32)
    prob = defn.make_problem(add_constraints=True).compile()
    rng = np.random.default_rng(0)
    xf = jnp.asarray(
        np.asarray(defn.xf)[:, None] + rng.uniform(-0.2, 0.2, (3, batch)),
        jnp.float32,
    )
    gi = next(
        i for i, f in enumerate(prob.constraint_families)
        if f.constraint.structure[0] == "goal"
    )
    cons = list(prob.params.constraints)
    cons[gi] = dict(cons[gi], xf=xf)
    cp0 = prob.params.costs[0]
    Q = jnp.asarray(cp0["Q"], jnp.float32)
    q = -jnp.einsum("kij,jb->kib", Q, xf)
    c = 0.5 * jnp.einsum("ib,kij,jb->kb", xf, Q, xf)
    params = prob.params.replace(
        x0=jnp.asarray(rng.uniform(-0.1, 0.1, (3, batch)), jnp.float32),
        constraints=tuple(cons),
        costs=(dict(cp0, q=q, c=c),),
    )
    Z0 = defn.initial_trajectory()
    Zb = to_batch_last(
        jax.tree_util.tree_map(
            lambda l: jnp.broadcast_to(l, (batch,) + l.shape), Z0
        )
    )
    opts = SolverOptions(
        backward_pass="fused", forward_pass="pallas", scan_unroll=4,
    )
    fast = ALSolverBatched(prob, opts)
    assert fast._use_fwd(params, Zb)
    rk = jax.jit(fast.solve)(params, Zb)
    scan = ALSolverBatched(prob, opts.replace(
        backward_pass="scan", forward_pass="scan"
    ))
    rs = jax.jit(scan.solve)(params, Zb)
    sk, ss = np.asarray(rk["status"]), np.asarray(rs["status"])
    assert float((sk == ss).mean()) >= 0.98
    assert int((sk == int(SolverStatus.SOLVED)).sum()) >= int(0.98 * batch)
    both = (sk == int(SolverStatus.SOLVED)) & (ss == int(SolverStatus.SOLVED))
    dU = np.abs(np.asarray(rk["Z"].U)[..., both] - np.asarray(rs["Z"].U)[..., both])
    assert float(np.percentile(dU, 99)) <= 2e-2


def test_compiled_device_cascade_improves_obstacle_fleet(gpu):
    """r5: the single-dispatch device pipeline (tail + restart cascade)
    on the compiled kernels converts the obstacle fleet's residue."""
    import jax.numpy as jnp

    from altro_jax import SolverOptions, SolverStatus
    from altro_jax.models.problems import UnicycleProblem
    from altro_jax.solver.batched import ALSolverBatched, to_batch_last
    from altro_jax.solver.compaction import CompactedALSolver

    batch = 1024
    defn = UnicycleProblem(scenario="three_obstacles", dtype=jnp.float32)
    prob = defn.make_problem(add_constraints=True).compile()
    rng = np.random.default_rng(0)
    params = prob.params.replace(
        x0=jnp.asarray(rng.uniform(-0.1, 0.1, (3, batch)), jnp.float32)
    )
    Z0 = defn.initial_trajectory()
    Zb = to_batch_last(
        jax.tree_util.tree_map(
            lambda l: jnp.broadcast_to(l, (batch,) + l.shape), Z0
        )
    )
    opts = SolverOptions(
        initial_penalty=1.0, line_search_max_iterations=20,
        max_stall_iterations=10, outer_constraints_f64=True,
        backward_pass="fused", forward_pass="pallas",
    )
    plain = ALSolverBatched(prob, opts)
    rp = jax.jit(plain.solve)(params, Zb)
    casc = CompactedALSolver(
        prob, opts, phase1_iters=14, tail_batch=batch, device_tail=True,
        restart_portfolio=(
            dict(),
            dict(penalty_scaling=4.0, max_iterations_outer=60,
                 max_iterations_total=900),
            dict(penalty_scaling=1.5, max_iterations_outer=120,
                 max_iterations_total=1100),
        ),
        restart_width=batch,
    )
    rc = casc.solve(params, Zb)
    solved = int(SolverStatus.SOLVED)
    n_plain = int((np.asarray(rp["status"]) == solved).sum())
    n_casc = int((np.asarray(rc["status"]) == solved).sum())
    assert n_casc > n_plain
    assert n_casc >= int(0.98 * batch), (n_casc, batch)
