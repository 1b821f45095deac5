"""Batch-last associative-scan Riccati: parity with the sequential sweep.

The per-instance solver already has a pscan backward pass
(`solver/pscan.py`, arXiv:1809.06360); `solver/pscan_batched.py` is its
lane-layout port for the batch-native solver.  The sequential scan is the
parity oracle (reference recursion: `altro/ilqr/ilqr.hpp:402-441`).
"""
import jax
import jax.numpy as jnp
import numpy as np

from altro_jax import SolverOptions, SolverStatus
from altro_jax.models.problems import UnicycleProblem
from altro_jax.solver.batched import ALSolverBatched, to_batch_last
from altro_jax.solver.pscan_batched import inv_unrolled, riccati_pscan_batched


def _setup(B=4, N=100, seed=0):
    defn = UnicycleProblem()
    defn.N = N
    defn.__post_init__()
    prob = defn.make_problem(add_constraints=True).compile()
    rng = np.random.default_rng(seed)
    params = prob.params.replace(
        x0=jnp.asarray(rng.uniform(-0.2, 0.2, size=(3, B)))
    )
    Zb = to_batch_last(
        jax.tree_util.tree_map(
            lambda l: jnp.broadcast_to(l, (B,) + l.shape),
            defn.initial_trajectory(),
        )
    )
    return prob, params, Zb


def test_inv_unrolled_matches_linalg():
    rng = np.random.default_rng(1)
    for n in (2, 3, 7):
        A = rng.standard_normal((5, n, n, 8))
        # make well-conditioned: I + C J structure (PSD product + identity)
        M = np.einsum("kijb,kjlb->kilb", A, np.swapaxes(A, 1, 2))
        M = M + np.eye(n)[None, :, :, None]
        Minv = np.asarray(inv_unrolled(jnp.asarray(M)))
        prod = np.einsum("kijb,kjlb->kilb", M, Minv)
        np.testing.assert_allclose(
            prod, np.broadcast_to(np.eye(n)[None, :, :, None], prod.shape),
            atol=1e-10,
        )


def test_pscan_sweep_matches_sequential_at_zero_reg():
    """At rho=0 the associative sweep equals the sequential recursion."""
    prob, params, Zb = _setup()
    solver = ALSolverBatched(prob, SolverOptions())
    B = Zb.X.shape[-1]
    al = solver.al_state_init(B, jnp.float64)
    Zr = solver.rollout(params, Zb)
    exp = solver.expand(params, al, Zr)
    rho = jnp.zeros((B,))
    K1, d1, v11, v21, f1 = solver.riccati_scan(exp, rho)
    K2, d2, v12, v22, f2 = riccati_pscan_batched(exp, rho)
    np.testing.assert_allclose(K1, K2, atol=1e-9)
    np.testing.assert_allclose(d1, d2, atol=1e-9)
    np.testing.assert_allclose(v11, v12, atol=1e-9)
    np.testing.assert_allclose(v21, v22, atol=1e-9)
    np.testing.assert_array_equal(np.asarray(f1), np.asarray(f2))


def test_pscan_sweep_matches_per_instance_pscan_regularized():
    """At rho>0 the oracle is the per-instance pscan (same control-cost
    regularization semantics; see pscan_batched module docstring)."""
    from altro_jax.solver.functions import Expansions
    from altro_jax.solver.pscan import backward_pass_pscan

    prob, params, Zb = _setup()
    solver = ALSolverBatched(prob, SolverOptions())
    B = Zb.X.shape[-1]
    al = solver.al_state_init(B, jnp.float64)
    Zr = solver.rollout(params, Zb)
    exp = solver.expand(params, al, Zr)
    rho_val = 0.37
    K2, d2, v12, v22, f2 = riccati_pscan_batched(
        exp, jnp.full((B,), rho_val)
    )

    def one(b):
        e = Expansions(
            costs=exp["costs"][:, b],
            lx=exp["lx"][..., b], lu=exp["lu"][..., b],
            lxx=exp["lxx"][..., b], lxu=exp["lxu"][..., b],
            luu=exp["luu"][..., b], A=exp["A"][..., b], B=exp["B"][..., b],
        )
        return backward_pass_pscan(
            e, jnp.asarray(rho_val), jnp.zeros(()), SolverOptions()
        )

    for b in range(B):
        bp = one(b)
        np.testing.assert_allclose(K2[..., b], bp.K, atol=1e-9)
        np.testing.assert_allclose(d2[..., b], bp.d, atol=1e-9)
        np.testing.assert_allclose(v12[b], bp.dV1, atol=1e-8)
        np.testing.assert_allclose(v22[b], bp.dV2, atol=1e-9)


def test_pscan_option_retired():
    """backward_pass='pscan' was retired in r5 — selecting it must fail
    loudly, pointing at the research entry points."""
    prob, params, Zb = _setup()
    import pytest as _pytest

    s = ALSolverBatched(prob, SolverOptions(backward_pass="pscan"))
    al = s.al_state_init(Zb.X.shape[-1], Zb.X.dtype)
    exp = s.expand(params, al, s.rollout(params, Zb))
    B = Zb.X.shape[-1]
    with _pytest.raises(ValueError, match="retired"):
        s.backward_pass(exp, jnp.zeros((B,)), jnp.zeros((B,)))


def test_pscan_full_solve_matches_scan():
    """The pscan sweep (research note) follows the same iteration path
    end-to-end when routed through the batched solver."""
    prob, params, Zb = _setup()
    r1 = jax.jit(ALSolverBatched(prob, SolverOptions(backward_pass="scan")).solve)(
        params, Zb
    )
    s2 = ALSolverBatched(prob, SolverOptions(backward_pass="scan"))
    s2.riccati_scan = lambda exp, rho: riccati_pscan_batched(
        exp, rho, gain_limit=s2.opts.bp_gain_limit
    )
    r2 = jax.jit(s2.solve)(params, Zb)
    np.testing.assert_array_equal(np.asarray(r1["status"]), np.asarray(r2["status"]))
    assert np.all(np.asarray(r1["status"]) == SolverStatus.SOLVED)
    np.testing.assert_array_equal(
        np.asarray(r1["stats"].iterations_total),
        np.asarray(r2["stats"].iterations_total),
    )
    np.testing.assert_allclose(
        np.asarray(r1["Z"].U), np.asarray(r2["Z"].U), atol=1e-6
    )


def test_pscan_cholesky_failure_mask():
    """A non-PD Quu at rho=0 flags exactly the affected instances, and the
    retry loop recovers them (`ilqr.hpp:409-427` analog)."""
    prob, params, Zb = _setup()
    solver = ALSolverBatched(prob, SolverOptions())
    B = Zb.X.shape[-1]
    al = solver.al_state_init(B, jnp.float64)
    Zr = solver.rollout(params, Zb)
    exp = solver.expand(params, al, Zr)
    # poison instance 1's control Hessian to be negative definite at knot 3
    luu = exp["luu"].at[3, :, :, 1].set(-jnp.eye(2))
    exp_bad = dict(exp, luu=luu)
    rho = jnp.zeros((B,))
    _, _, _, _, failed = riccati_pscan_batched(exp_bad, rho)
    np.testing.assert_array_equal(
        np.asarray(failed), np.asarray([False, True, False, False])
    )
    # retry loop recovers via per-instance regularization (pscan sweep
    # routed directly; the option itself is retired)
    s_ps = ALSolverBatched(prob, SolverOptions(backward_pass="scan"))
    s_ps.riccati_scan = lambda e, r: riccati_pscan_batched(
        e, r, gain_limit=s_ps.opts.bp_gain_limit
    )
    out = s_ps.backward_pass(exp_bad, rho, jnp.zeros((B,)))
    assert not np.any(np.asarray(out["failed"]))
    assert np.asarray(out["rho"])[1] > 0.0
