"""Parallel-prefix Riccati backward sweep in batch-last layout.

Port of :mod:`altro_jax.solver.pscan` (associative-scan Riccati,
arXiv:1809.06360 — the O(log N)-depth replacement for the reference's
strictly sequential backward recursion, `altro/ilqr/ilqr.hpp:402-441`) to the
batch-native solver's lane layout: every array carries the instance batch in
the LAST axis ([N, n, n, B] etc.), so all small-matrix algebra is
broadcast-multiply-reduce over the tiny contraction axes and fully
elementwise over the batch (`solver/batched.py:mm`).

The n×n inverses inside the associative combine are unrolled Gauss-Jordan
over static indices (`inv_unrolled`) — the general-matrix analog of
`chol_unrolled`.  M = I + C·J with C, J PSD has eigenvalues ≥ 1, so
pivot-free elimination is safe here.  (I + J·C)⁻¹ is recovered from
(I + C·J)⁻¹ via the push-through identity instead of a second elimination.

Regularization semantics: at rho=0 this sweep equals the sequential
recursion to rounding.  At rho>0 the two differ by construction — the
associative elements eliminate the control against the REGULARIZED control
cost (luu + rho·I), so the propagated cost-to-go is that of the
control-cost-regularized LQR problem, whereas the sequential pass
(`riccati_scan`, mirroring `knot_point_function_type.hpp:175-230`)
regularizes only the gain solve and propagates the unregularized Quu.  That
mixed update is not the Riccati recursion of any LQR problem and therefore
has no associative form; both variants are valid damped-Newton steps and the
solver's retry/line-search logic treats them identically.  The per-instance
pscan (`solver/pscan.py`) makes the same choice and is this module's parity
oracle at rho>0.

Trade-off vs the sequential sweep (measured in
`perf/benchmark_scaling.py --backward`): the scan's critical path is N steps
of ~6 small matmuls; the parallel version is ~log₂N combine levels of ~8
matmuls + an inverse, but each level is one big [N, ...] elementwise kernel.
At large B the lanes are already saturated and the sequential sweep's lower
total FLOPs win; pscan pays off for long horizons at small-to-moderate B
where depth, not width, bounds throughput.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .batched import (
    chol_failed,
    chol_solve_mat,
    chol_solve_vec,
    chol_unrolled,
    dotv,
    mm,
    mT,
    mv,
)


def inv_unrolled(M):
    """Inverse of [..., n, n, B] via pivot-free Gauss-Jordan unrolled over
    static indices; every operation is elementwise over the lane axis."""
    n = M.shape[-3]
    a = [[M[..., i, j, :] for j in range(n)] for i in range(n)]
    one = jnp.ones_like(M[..., 0, 0, :])
    zero = jnp.zeros_like(one)
    inv = [[one if i == j else zero for j in range(n)] for i in range(n)]
    for k in range(n):
        ipiv = 1.0 / a[k][k]
        a[k] = [x * ipiv for x in a[k]]
        inv[k] = [x * ipiv for x in inv[k]]
        for i in range(n):
            if i == k:
                continue
            f = a[i][k]
            a[i] = [x - f * y for x, y in zip(a[i], a[k])]
            inv[i] = [x - f * y for x, y in zip(inv[i], inv[k])]
    return jnp.stack(
        [jnp.stack(row, axis=-2) for row in inv], axis=-3
    )  # [..., n, n, B]


def _safe(L):
    """Replace non-finite Cholesky factors so downstream solves stay finite
    (failure is reported separately via chol_failed)."""
    return [
        [None if e is None else jnp.where(jnp.isfinite(e), e, 1.0) for e in row]
        for row in L
    ]


def _combine(e_next, e_prev):
    """Associative combination, batch-last (`pscan._combine` port).

    e_prev covers the earlier interval, e_next the later; all leaves
    [..., n(, n), B].
    """
    Fi, fi, Ci, Ji, etai = e_prev
    Fj, fj, Cj, Jj, etaj = e_next
    n = Fi.shape[-3]
    I = jnp.eye(n, dtype=Fi.dtype)[..., None]
    Minv = inv_unrolled(I + mm(Ci, Jj))
    FjM = mm(Fj, Minv)
    F = mm(FjM, Fi)
    f = mv(FjM, fi + mv(Ci, etaj)) + fj
    C = mm(FjM, mm(Ci, mT(Fj))) + Cj
    # (I + Jj Ci)^{-1} = I - Jj Minv Ci  (push-through identity)
    Ntinv = I - mm(Jj, mm(Minv, Ci))
    FiT = mT(Fi)
    J = mm(FiT, mm(Ntinv, mm(Jj, Fi))) + Ji
    eta = mv(FiT, mv(Ntinv, etaj - mv(Jj, fi))) + etai
    return (F, f, C, J, eta)


def riccati_pscan_batched(exp: dict, rho, gain_limit: float = 1e8):
    """One full backward sweep at fixed per-instance regularization rho [B].

    Same contract as `ALSolverBatched.riccati_scan`: returns
    (K [N,m,n,B], d [N,m,B], dV1 [B], dV2 [B], failed [B]).  Gains above
    `gain_limit` count as failure (SolverOptions.bp_gain_limit).
    """
    N = exp["A"].shape[0]
    n = exp["A"].shape[1]
    m = exp["B"].shape[2]
    dt = exp["A"].dtype
    A, Bd = exp["A"], exp["B"]
    lxx, lxu, luu = exp["lxx"][:N], exp["lxu"][:N], exp["luu"][:N]
    lx, lu = exp["lx"][:N], exp["lu"][:N]
    eye_m = jnp.eye(m, dtype=dt)[..., None]
    eye_n = jnp.eye(n, dtype=dt)[..., None]

    # ---------------- per-step elements (pscan._elem_from_step port)
    luu_reg = luu + eye_m * rho
    L = chol_unrolled(luu_reg)
    fail_elem = chol_failed(L)  # [N, B]
    Ls = _safe(L)
    Kc = chol_solve_mat(Ls, mT(lxu))  # [N, m, n, B]
    kc = chol_solve_vec(Ls, lu)  # [N, m, B]
    luu_invBt = chol_solve_mat(Ls, mT(Bd))  # [N, m, n', B] (n' = n)
    F = A - mm(Bd, Kc)
    f = -mv(Bd, kc)
    C = mm(Bd, luu_invBt)
    Jc = lxx - mm(lxu, Kc)
    eta = -(lx - mv(lxu, kc))

    # ---------------- suffix scan (element k composed with all later steps)
    suffix = jax.lax.associative_scan(
        _combine, (F, f, C, Jc, eta), reverse=True
    )
    Fs, fs, Cs, Js, etas = suffix

    # ---------------- close against the terminal cost-to-go
    PN = exp["lxx"][N]  # [n, n, B]
    pN = exp["lx"][N]  # [n, B]
    Minv = inv_unrolled(eye_n + mm(PN[None], Cs))
    PM = mm(Minv, PN[None])
    Pk = Js + mm(mT(Fs), mm(PM, Fs))
    pk = -etas + mv(mT(Fs), mv(Minv, pN[None] + mv(PN[None], fs)))
    P = jnp.concatenate([Pk, PN[None]], axis=0)  # [N+1, n, n, B]
    p = jnp.concatenate([pk, pN[None]], axis=0)

    # ---------------- gains from P_{k+1}, p_{k+1}, same as the sequential pass
    Pn, pn = P[1:], p[1:]
    AtP = mm(mT(A), Pn)
    Qxu = lxu + mm(AtP, Bd)
    Quu = luu + mm(mT(Bd), mm(Pn, Bd))
    Qu = lu + mv(mT(Bd), pn)
    Lg = chol_unrolled(Quu + eye_m * rho)
    fail_g = chol_failed(Lg)
    Lgs = _safe(Lg)
    K = -chol_solve_mat(Lgs, mT(Qxu))
    d = -chol_solve_vec(Lgs, Qu)
    dV1 = dotv(d, Qu).sum(axis=0)
    dV2 = 0.5 * dotv(d, mv(Quu, d)).sum(axis=0)

    # gain-magnitude guard (SolverOptions.bp_gain_limit), NaN-safe
    gains_ok = (
        jnp.max(jnp.abs(K), axis=(0, 1, 2)) <= gain_limit
    ) & (jnp.max(jnp.abs(d), axis=(0, 1)) <= gain_limit)
    failed = (
        jnp.any(fail_elem, axis=0)
        | jnp.any(fail_g, axis=0)
        | ~jnp.all(jnp.isfinite(P), axis=(0, 1, 2))
        | ~gains_ok
    )
    return K, d, dV1, dV2, failed
