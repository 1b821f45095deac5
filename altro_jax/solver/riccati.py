"""Riccati backward pass kernels.

Sequential `lax.scan` recursion (the parity oracle, mirroring
`iLQR::BackwardPass` / `KnotPointFunctions::CalcActionValueExpansion..
CalcCostToGo`, `altro/ilqr/ilqr.hpp:385-445`,
`ilqr/knot_point_function_type.hpp:149-235`) plus the regularization retry
loop.  Cholesky failure — Eigen `LLT::info()` in the reference
(`knot_point_function_type.hpp:197-211`) — is detected on device via NaN
checks on `jnp.linalg.cholesky`, and the whole pass retries with increased
regularization inside a `lax.while_loop` (the reference restarts its k-loop
from N-1, `ilqr.hpp:409-427`; restarting the whole scan is equivalent since
the terminal cost-to-go is unchanged).

An associative-scan (parallel-prefix) variant for long horizons lives in
:mod:`altro_jax.solver.pscan` (arXiv:1809.06360).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy.linalg import cho_solve

from .._pytree import pytree_dataclass, tree_select
from ..options import SolverOptions
from ..types import SolverStatus
from .functions import Expansions


@pytree_dataclass
class BackwardPassResult:
    K: jax.Array  # [N, m, n] feedback gains
    d: jax.Array  # [N, m] feedforward gains
    P: jax.Array  # [N+1, n, n] cost-to-go Hessians
    p: jax.Array  # [N+1, n] cost-to-go gradients
    dV1: jax.Array  # expected decrease, linear term  Σ dᵀQu
    dV2: jax.Array  # expected decrease, quadratic term  Σ ½dᵀQuu d
    rho: jax.Array  # regularization after the pass (pre-decrease)
    drho: jax.Array
    status: jax.Array  # SolverStatus (BACKWARD_PASS_.._FAILED on give-up)
    failed: jax.Array  # bool


def increase_regularization(rho, drho, opts: SolverOptions):
    """ρ,dρ damped increase schedule (`ilqr.hpp:770-775`)."""
    drho = jnp.maximum(drho * opts.bp_reg_increase_factor, opts.bp_reg_increase_factor)
    rho = jnp.clip(rho * drho, opts.bp_reg_min, opts.bp_reg_max)
    return rho, drho


def decrease_regularization(rho, drho, opts: SolverOptions):
    """ρ,dρ damped decrease schedule (`ilqr.hpp:781-786`)."""
    drho = jnp.minimum(drho / opts.bp_reg_increase_factor, 1.0 / opts.bp_reg_increase_factor)
    rho = jnp.clip(rho * drho, opts.bp_reg_min, opts.bp_reg_max)
    return rho, drho


def _riccati_scan(exp: Expansions, rho, gain_limit: float = 1e8):
    """One full backward sweep at fixed regularization.

    Returns (K, d, P, p, dV1, dV2, failed).  On a non-PD regularized Quu the
    remaining (earlier-k) carry updates freeze, matching the reference's
    break-out (`ilqr.hpp:409-427`); the caller retries with larger rho.
    Gains beyond `gain_limit` count as failure too (a finite-but-singular
    factorization produces unbounded gains that can never yield an accepted
    step — see SolverOptions.bp_gain_limit).
    """
    N = exp.A.shape[0]
    m = exp.B.shape[-1]
    PN = exp.lxx[N]
    pN = exp.lx[N]
    eye_m = jnp.eye(m, dtype=exp.A.dtype)

    def step(carry, inp):
        P, p, dV1, dV2, failed = carry
        A, B, lxx, lxu, luu, lx, lu = inp
        # Action-value expansion (`knot_point_function_type.hpp:149-164`)
        AtP = A.T @ P
        Qxx = lxx + AtP @ A
        Qxu = lxu + AtP @ B
        Quu = luu + B.T @ (P @ B)
        Qx = lx + A.T @ p
        Qu = lu + B.T @ p
        # Control-only regularization (`knot_point_function_type.hpp:175-186`)
        Quu_reg = Quu + rho * eye_m
        L = jnp.linalg.cholesky(Quu_reg)
        fail_k = ~jnp.all(jnp.isfinite(L))
        Lsafe = jnp.where(jnp.isfinite(L), L, eye_m)
        # Gains (`knot_point_function_type.hpp:197-211`)
        K = -cho_solve((Lsafe, True), Qxu.T)
        d = -cho_solve((Lsafe, True), Qu)
        # NaN-safe magnitude guard: ~(x <= lim) is True for NaN/inf too
        fail_k = fail_k | ~(
            jnp.max(jnp.abs(K)) <= gain_limit
        ) | ~(jnp.max(jnp.abs(d)) <= gain_limit)
        # Cost-to-go with the UNregularized action-value expansion
        # (`knot_point_function_type.hpp:220-230`)
        KtQuu = K.T @ Quu
        p_new = Qx + KtQuu @ d + K.T @ Qu + Qxu @ d
        P_new = Qxx + KtQuu @ K + K.T @ Qxu.T + Qxu @ K
        dV1_new = dV1 + d @ Qu
        dV2_new = dV2 + 0.5 * d @ (Quu @ d)
        new_failed = failed | fail_k
        new_carry = tree_select(
            new_failed,
            (P, p, dV1, dV2, new_failed),
            (P_new, p_new, dV1_new, dV2_new, new_failed),
        )
        return new_carry, (K, d, P_new, p_new)

    zero = jnp.zeros((), exp.A.dtype)
    init = (PN, pN, zero, zero, jnp.zeros((), bool))
    xs = (exp.A, exp.B, exp.lxx[:N], exp.lxu[:N], exp.luu[:N], exp.lx[:N], exp.lu[:N])
    (Pf, pf, dV1, dV2, failed), (K, d, Ps, ps) = jax.lax.scan(
        step, init, xs, reverse=True
    )
    # Stack cost-to-go including terminal (`CalcTerminalCostToGo`,
    # `knot_point_function_type.hpp:135-138`)
    P = jnp.concatenate([Ps, PN[None]], axis=0)
    p = jnp.concatenate([ps, pN[None]], axis=0)
    return K, d, P, p, dV1, dV2, failed


def backward_pass(
    exp: Expansions, rho, drho, opts: SolverOptions
) -> BackwardPassResult:
    """Full backward pass with regularization-retry loop (`ilqr.hpp:385-445`)."""
    N = exp.A.shape[0]
    n = exp.A.shape[-1]
    m = exp.B.shape[-1]
    dt = exp.A.dtype

    def attempt(rho):
        return _riccati_scan(exp, rho, gain_limit=opts.bp_gain_limit)

    def cond(state):
        _, _, _, _, _, _, failed, _, _, _, done = state
        return ~done

    def body(state):
        K, d, P, p, dV1, dV2, _, rho, drho, count, _ = state
        K, d, P, p, dV1, dV2, failed = attempt(rho)

        def on_fail(args):
            rho, drho, count = args
            rho2, drho2 = increase_regularization(rho, drho, opts)
            count2 = count + jnp.where(rho2 >= opts.bp_reg_max, 1, 0)
            return rho2, drho2, count2

        rho2, drho2, count2 = jax.lax.cond(
            failed, on_fail, lambda a: a, (rho, drho, count)
        )
        give_up = failed & (count2 >= opts.bp_reg_fail_threshold)
        done = (~failed) | give_up
        return (K, d, P, p, dV1, dV2, failed, rho2, drho2, count2, done)

    zero = jnp.zeros((), dt)
    init = (
        jnp.zeros((N, m, n), dt),
        jnp.zeros((N, m), dt),
        jnp.zeros((N + 1, n, n), dt),
        jnp.zeros((N + 1, n), dt),
        zero,
        zero,
        jnp.ones((), bool),
        jnp.asarray(rho, dt),
        jnp.asarray(drho, dt),
        jnp.zeros((), jnp.int32),
        jnp.zeros((), bool),
    )
    K, d, P, p, dV1, dV2, failed, rho, drho, count, _ = jax.lax.while_loop(
        cond, body, init
    )
    status = jnp.where(
        failed,
        jnp.int32(SolverStatus.BACKWARD_PASS_REGULARIZATION_FAILED),
        jnp.int32(SolverStatus.UNSOLVED),
    )
    return BackwardPassResult(
        K=K, d=d, P=P, p=p, dV1=dV1, dV2=dV2, rho=rho, drho=drho,
        status=status, failed=failed,
    )
