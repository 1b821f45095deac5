"""Parallel-prefix (associative scan) Riccati backward pass.

Parallel replacement for the strictly sequential backward recursion
(`altro/ilqr/ilqr.hpp:402-441`): the LQR value-function recursion is
composed as an associative operation over time steps and evaluated with
`jax.lax.associative_scan` in O(log N) depth (arXiv:1809.06360, "The
Parallelization of Riccati Recursion").

Formulation.  For the time-varying LQR subproblem built from the expansions,
define per-step elements of the value-function composition in the
"conditional value function" parametrization

    V_k(x_k | x_{k+1}) :  x_{k+1} = F x_k + f  (+ noise-free),
    element e_k = (F, f, C, eta, J)

with combine rule (Särkkä & García-Fernández-style parallel LQR/Kalman
duality) — see `combine()` below.  After the scan, gains are recovered
per-step from the suffix cost-to-go, identically to the sequential pass.

The regularized-Quu failure semantics match the sequential kernel: if any
regularized Quu is non-PD the whole pass reports failure and the caller's
retry loop increases rho.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy.linalg import cho_solve

from ..options import SolverOptions
from ..types import SolverStatus
from .functions import Expansions
from . import riccati


def _elem_from_step(A, B, lxx, lxu, luu, lx, lu, rho, eye_m):
    """Build the associative element for one time step.

    Eliminates the control from the one-step transition using the regularized
    luu (control cost + rho I), yielding an affine-Gaussian-style element
      F = A - B Kc,  f = -B kc,  C = B (luu_reg)^{-1} B^T,
      eta/J the value-function accumulators,
    following the parametrization of arXiv:1809.06360 §III.
    """
    luu_reg = luu + rho * eye_m
    L = jnp.linalg.cholesky(luu_reg)
    ok = jnp.all(jnp.isfinite(L))
    Lsafe = jnp.where(jnp.isfinite(L), L, eye_m)
    luu_inv = cho_solve((Lsafe, True), eye_m)
    Kc = luu_inv @ lxu.T  # (m,n)
    kc = luu_inv @ lu  # (m,)
    F = A - B @ Kc
    f = -(B @ kc)
    C = B @ luu_inv @ B.T
    Jc = lxx - lxu @ Kc
    eta = -(lx - lxu @ kc)
    return (F, f, C, Jc, eta), ok


def _combine(e_next, e_prev):
    """Associative combination of two consecutive elements.

    e_prev covers the earlier time interval, e_next the later one; returns
    the element for the concatenated interval (arXiv:1809.06360 eq. (9)-(10);
    also jax.lax.associative_scan convention with reverse=True).
    """
    Fi, fi, Ci, Ji, etai = e_prev
    Fj, fj, Cj, Jj, etaj = e_next
    n = Fi.shape[-1]
    I = jnp.eye(n, dtype=Fi.dtype)
    M = I + Ci @ Jj
    # Solve instead of inverse for stability
    Minv = jnp.linalg.solve(M, I)
    F = Fj @ Minv @ Fi
    f = Fj @ Minv @ (fi + Ci @ etaj) + fj
    C = Fj @ Minv @ Ci @ Fj.T + Cj
    Nt = I + Jj @ Ci
    Ntinv = jnp.linalg.solve(Nt, I)
    J = Fi.T @ Ntinv @ Jj @ Fi + Ji
    eta = Fi.T @ Ntinv @ (etaj - Jj @ fi) + etai
    return (F, f, C, J, eta)


def backward_pass_pscan(exp: Expansions, rho, drho, opts: SolverOptions):
    """Backward pass via associative scan, with the same retry loop and
    result container as :func:`altro_jax.solver.riccati.backward_pass`."""
    N = exp.A.shape[0]
    n = exp.A.shape[-1]
    m = exp.B.shape[-1]
    dt = exp.A.dtype
    eye_m = jnp.eye(m, dtype=dt)

    def attempt(rho):
        elems, oks = jax.vmap(
            lambda A, B, lxx, lxu, luu, lx, lu: _elem_from_step(
                A, B, lxx, lxu, luu, lx, lu, rho, eye_m
            )
        )(exp.A, exp.B, exp.lxx[:N], exp.lxu[:N], exp.luu[:N], exp.lx[:N], exp.lu[:N])
        # Suffix combine: element k composed with everything after it.
        suffix = jax.lax.associative_scan(
            lambda a, b: jax.vmap(_combine)(a, b), elems, reverse=True
        )
        F, f, C, Jmat, eta = suffix
        PN = exp.lxx[N]
        pN = exp.lx[N]
        I = jnp.eye(n, dtype=dt)

        def value_at(Fk, fk, Ck, Jk, etak):
            # Close the suffix element against the terminal cost:
            # P_k = J_k + F^T (I + P_N C)^{-1} P_N F, analogous closure for p.
            M = I + PN @ Ck
            Minv = jnp.linalg.solve(M, I)
            PM = Minv @ PN
            P = Jk + Fk.T @ PM @ Fk
            p = -etak + Fk.T @ Minv @ (pN + PN @ fk)
            return P, p

        Pk, pk = jax.vmap(value_at)(F, f, C, Jmat, eta)
        P = jnp.concatenate([Pk, PN[None]], axis=0)
        p = jnp.concatenate([pk, pN[None]], axis=0)

        # Recover gains identically to the sequential pass from P_{k+1}, p_{k+1}
        def gains(A, B, lxx, lxu, luu, lx, lu, Pn, pn):
            AtP = A.T @ Pn
            Qxu = lxu + AtP @ B
            Quu = luu + B.T @ (Pn @ B)
            Qu = lu + B.T @ pn
            Quu_reg = Quu + rho * eye_m
            L = jnp.linalg.cholesky(Quu_reg)
            ok = jnp.all(jnp.isfinite(L))
            Lsafe = jnp.where(jnp.isfinite(L), L, eye_m)
            K = -cho_solve((Lsafe, True), Qxu.T)
            d = -cho_solve((Lsafe, True), Qu)
            dV1 = d @ Qu
            dV2 = 0.5 * d @ (Quu @ d)
            return K, d, dV1, dV2, ok

        K, d, dV1s, dV2s, ok_g = jax.vmap(gains)(
            exp.A, exp.B, exp.lxx[:N], exp.lxu[:N], exp.luu[:N],
            exp.lx[:N], exp.lu[:N], P[1:], p[1:],
        )
        # gain-magnitude guard (SolverOptions.bp_gain_limit), NaN-safe
        glim = opts.bp_gain_limit
        gains_ok = (
            jnp.max(jnp.abs(K)) <= glim
        ) & (jnp.max(jnp.abs(d)) <= glim)
        failed = (
            (~jnp.all(oks)) | (~jnp.all(ok_g)) | (~jnp.all(jnp.isfinite(P)))
            | ~gains_ok
        )
        return K, d, P, p, dV1s.sum(), dV2s.sum(), failed

    def cond(state):
        return ~state[-1]

    def body(state):
        K, d, P, p, dV1, dV2, _, rho_c, drho_c, count, _ = state
        K, d, P, p, dV1, dV2, failed = attempt(rho_c)

        def on_fail(args):
            r, dr, c = args
            r2, dr2 = riccati.increase_regularization(r, dr, opts)
            return r2, dr2, c + jnp.where(r2 >= opts.bp_reg_max, 1, 0)

        rho2, drho2, count2 = jax.lax.cond(
            failed, on_fail, lambda a: a, (rho_c, drho_c, count)
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
    return riccati.BackwardPassResult(
        K=K, d=d, P=P, p=p, dV1=dV1, dV2=dV2, rho=rho, drho=drho,
        status=status, failed=failed,
    )
