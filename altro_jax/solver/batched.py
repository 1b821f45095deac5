"""Batch-native AL-iLQR: thousands of solves with the batch as the last axis.

Why this module exists.  `jax.vmap` of the per-instance solver puts the batch
axis FIRST, so every tiny-matrix op compiles as `[B, 3, 3]` batched algebra
whose innermost axes are the size-3 matrix dims.  Here the batch lives in the
LAST axis: every state is `[..., n, B]`, all small-matrix algebra is
broadcast-multiply-reduce over the tiny contraction axes (elementwise over B
— see `mm()` for why einsum is the wrong lowering), and the m×m Cholesky
factor/solve is unrolled over static indices into `[B]`-wide elementwise
ops, so every operation is a contiguous, fully parallel sweep over the
batch.

Semantics match the per-instance solver (`solver/ilqr.py`, `solver/al.py`)
instance-by-instance: each batch element follows the same iteration path it
would take alone, with per-instance regularization, line-search α, dual and
penalty state, and convergence masks freezing finished instances — the
functional replacement for running the reference solver in a loop
(`perf/benchmark_unicycle.cpp:45-75`).

Layout convention: batch axis LAST.
  X [N+1, n, B]   U [N, m, B]   K [N, m, n, B]   d [N, m, B]
  lam [nk, p, B]  rho [nk, B]   scalars [B]
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .._pytree import pytree_dataclass, static_field, with_matmul_precision
from ..options import SolverOptions
from ..problem.constraints import Cone, dual_cone
from ..problem.costs import _quadcost_eval
from ..problem.problem import CompiledProblem, ProblemParams
from ..types import SolverStatus

# ----------------------------------------------------------------- helpers


def mm(a, b):
    """[..., i, j, B] @ [..., j, k, B] -> [..., i, k, B].

    Written as broadcast-multiply-reduce, NOT einsum: einsum lowers to a
    dot_general whose output is batch-LEADING plus a transpose back, which
    both moves the batch out of the last axis and floods the program with
    transposes.  The contraction axes here are tiny (n, m <= ~13), far below
    what a matrix unit can use, so elementwise multiply + reduce that XLA
    fuses is the fast form.
    """
    return (a[..., :, :, None, :] * b[..., None, :, :, :]).sum(axis=-3)


def mv(a, v):
    """[..., i, j, B] @ [..., j, B] -> [..., i, B]."""
    return (a * v[..., None, :, :]).sum(axis=-2)


def mT(a):
    return jnp.swapaxes(a, -3, -2)


def dotv(a, b):
    """[..., i, B] · [..., i, B] -> [..., B]."""
    return jnp.sum(a * b, axis=-2)


def chol_unrolled(M):
    """Cholesky of [..., m, m, B] unrolled over static indices.

    Returns L (lower) with NaNs where the matrix is not PD — the batched
    analog of Eigen LLT failure (`knot_point_function_type.hpp:197-211`).
    Every operation is elementwise over the lane (batch) axis.
    """
    m = M.shape[-3]
    cols = [[None] * m for _ in range(m)]
    for j in range(m):
        s = M[..., j, j, :] - sum(
            (cols[j][k] * cols[j][k] for k in range(j)), start=0.0
        )
        dj = jnp.sqrt(s)
        cols[j][j] = dj
        inv_dj = 1.0 / dj
        for i in range(j + 1, m):
            s = M[..., i, j, :] - sum(
                (cols[i][k] * cols[j][k] for k in range(j)), start=0.0
            )
            cols[i][j] = s * inv_dj
    return cols  # lower-triangular entries [i][j] as [..., B] arrays


def chol_solve_mat(L, R):
    """Solve (L Lᵀ) X = R with R [..., m, r, B], L from chol_unrolled."""
    m = len(L)
    r = R.shape[-2]
    # forward: L y = R
    y = [None] * m
    for i in range(m):
        acc = R[..., i, :, :] - sum(
            (L[i][k][..., None, :] * y[k] for k in range(i)), start=0.0
        )
        y[i] = acc / L[i][i][..., None, :]
    # backward: Lᵀ x = y
    x = [None] * m
    for i in reversed(range(m)):
        acc = y[i] - sum(
            (L[k][i][..., None, :] * x[k] for k in range(i + 1, m)), start=0.0
        )
        x[i] = acc / L[i][i][..., None, :]
    return jnp.stack(x, axis=-3)  # [..., m, r, B]


def chol_solve_vec(L, v):
    """Solve (L Lᵀ) x = v with v [..., m, B]."""
    return chol_solve_mat(L, v[..., :, None, :])[..., :, 0, :]


def chol_failed(L):
    """Per-instance failure mask [..., B]: any non-finite factor entry
    (covers NaN pivots AND inf off-diagonals from a zero pivot)."""
    bad = None
    for i, row in enumerate(L):
        for j in range(i + 1):
            b = ~jnp.isfinite(row[j])
            bad = b if bad is None else bad | b
    return bad


def bwhere(mask, a, b):
    """where with a trailing-batch mask [B] against [..., B] arrays."""
    return jnp.where(mask, a, b)


def soc_project_bl(s):
    """Lorentz-cone projection, batch-last: s [nk, p, B] with the cone scalar
    in row p-1 (`constraints._soc_project` is the per-instance form)."""
    v = s[:, :-1, :]
    t = s[:, -1, :]
    a = jnp.sqrt(jnp.sum(v * v, axis=1))  # [nk, B]
    eps = jnp.asarray(jnp.finfo(s.dtype).tiny, s.dtype)
    inside = a <= t
    polar = a <= -t
    scale = 0.5 * (1.0 + t / jnp.maximum(a, eps))
    proj = jnp.concatenate(
        [scale[:, None, :] * v, (0.5 * (a + t))[:, None, :]], axis=1
    )
    return jnp.where(
        inside[:, None, :], s, jnp.where(polar[:, None, :], 0.0, proj)
    )


def soc_jacobian_bl(s):
    """Projection Jacobian of the Lorentz cone, batch-last: [nk, p, p, B]
    (`constraints.cone_jacobian` is the per-instance form)."""
    nk, p, Bsz = s.shape
    dt = s.dtype
    v = s[:, :-1, :]
    t = s[:, -1, :]
    a = jnp.sqrt(jnp.sum(v * v, axis=1))
    eps = jnp.asarray(jnp.finfo(dt).tiny, dt)
    a_s = jnp.maximum(a, eps)
    inside = a <= t
    polar = a <= -t
    c = 0.5 + t / (2.0 * a_s)
    vv = v[:, :, None, :] * v[:, None, :, :]  # [nk, p-1, p-1, B]
    eye_v = jnp.eye(p - 1, dtype=dt)[None, :, :, None]
    dPv_dv = c[:, None, None, :] * eye_v - (t / (2.0 * a_s**3))[
        :, None, None, :
    ] * vv
    dPv_dt = v / (2.0 * a_s[:, None, :])  # [nk, p-1, B]
    top = jnp.concatenate([dPv_dv, dPv_dt[:, :, None, :]], axis=2)
    half = jnp.full((nk, 1, 1, Bsz), 0.5, dt)
    bot = jnp.concatenate([dPv_dt[:, None, :, :], half], axis=2)
    J = jnp.concatenate([top, bot], axis=1)  # [nk, p, p, B]
    eye_p = jnp.eye(p, dtype=dt)[None, :, :, None]
    return jnp.where(
        inside[:, None, None, :],
        eye_p,
        jnp.where(polar[:, None, None, :], jnp.zeros((), dt), J),
    )


def batch_axes(canon, actual):
    """Per-leaf vmap axis spec for possibly per-instance problem params.

    The batch-last convention for varying problem data across instances is a
    TRAILING batch axis on the param leaf (e.g. goal `q` [n] → [n, B],
    obstacle centers [n_obs] → [n_obs, B]).  A leaf is per-instance iff its
    ndim exceeds the canonical (unbatched) leaf's by one; this returns -1 for
    those leaves and None for shared ones — directly usable as a `vmap`
    in_axes pytree.  This is the batched analog of the reference's
    loop-of-solves with different problem objects per iteration
    (`perf/benchmark_unicycle.cpp:45-75`).
    """
    return jax.tree_util.tree_map(
        lambda c, a: -1 if jnp.ndim(a) == jnp.ndim(c) + 1 else None,
        canon,
        actual,
    )


def any_batched(canon, actual) -> bool:
    """True if any leaf of `actual` carries a trailing batch axis."""
    return any(
        jnp.ndim(a) == jnp.ndim(c) + 1
        for c, a in zip(
            jax.tree_util.tree_leaves(canon), jax.tree_util.tree_leaves(actual)
        )
    )


def btree_select(mask, on_true, on_false):
    return jax.tree_util.tree_map(lambda a, b: jnp.where(mask, a, b), on_true, on_false)


def zselect(mask, Za, Zb):
    """Masked select on BatchedTrajectory (t, h carry no batch axis)."""
    return dataclasses.replace(
        Za, X=jnp.where(mask, Za.X, Zb.X), U=jnp.where(mask, Za.U, Zb.U)
    )


# ----------------------------------------------------------------- state


@pytree_dataclass
class BatchedStats:
    """Per-instance counters and convergence scalars, shapes [B].

    `rows` is the per-iteration history — the batched analog of the
    reference's per-iteration stats vectors (`solver_stats.hpp:54-61`) and of
    `SolverStats.rows` in the per-instance solver: `[capacity, 8, B]` in
    `types._COLUMNS` order (cost, alpha, improvement_ratio, gradient,
    cost_decrease, regularization, violations, max_penalty), row i holding
    instance b's values after its (i+1)-th total iteration.  Capacity 0
    (the default) disables recording and costs nothing.
    """

    iterations_inner: jax.Array
    iterations_outer: jax.Array
    iterations_total: jax.Array
    initial_cost: jax.Array
    cost: jax.Array
    cost_decrease: jax.Array
    gradient: jax.Array
    alpha: jax.Array
    improvement_ratio: jax.Array
    violations: jax.Array
    max_penalty: jax.Array
    regularization: jax.Array
    rows: jax.Array  # [capacity, 8, B]


_HISTORY_COLUMNS = (
    "cost",
    "alpha",
    "improvement_ratio",
    "gradient",
    "cost_decrease",
    "regularization",
    "violations",
    "max_penalty",
)


def batched_stats_init(B: int, dtype, history_capacity: int = 0) -> BatchedStats:
    z = jnp.zeros((B,), dtype)
    i = jnp.zeros((B,), jnp.int32)
    return BatchedStats(
        iterations_inner=i, iterations_outer=i, iterations_total=i,
        initial_cost=z, cost=z, cost_decrease=z, gradient=z, alpha=z,
        improvement_ratio=z, violations=z, max_penalty=z, regularization=z,
        rows=jnp.zeros((history_capacity, len(_HISTORY_COLUMNS), B), dtype),
    )


def batched_stats_column(stats: BatchedStats, name: str) -> jax.Array:
    """History column `name` as [capacity, B]; instance b's rows are valid up
    to `stats.iterations_total[b]` (`types.stats_column` analog)."""
    return stats.rows[:, _HISTORY_COLUMNS.index(name), :]


def _record_history(stats: BatchedStats, active) -> BatchedStats:
    """Write the current column values into each active instance's row
    `iterations_total-1` (call after the per-iteration stats update).

    Written as a batch-last one-hot masked select, NOT advanced indexing:
    `rows[idx, :, lanes]` gathers/scatters into a batch-LEADING [B, 8]
    layout, and the transposes of the [cap, 8, B] buffer it induces were
    a large share of the whole solve at B=4096."""
    cap = stats.rows.shape[0]
    if cap == 0:
        return stats
    vals = jnp.stack(
        [getattr(stats, name) for name in _HISTORY_COLUMNS], axis=0
    )  # [8, B]
    idx = jnp.clip(stats.iterations_total - 1, 0, cap - 1)  # [B]
    r = jnp.arange(cap)[:, None, None]  # [cap, 1, 1]
    write = (r == idx[None, None, :]) & active[None, None, :]
    return stats.replace(rows=jnp.where(write, vals[None], stats.rows))


@pytree_dataclass
class BatchedTrajectory:
    """Batch-last trajectory: X [N+1, n, B], U [N, m, B]; shared t, h."""

    X: jax.Array
    U: jax.Array
    t: jax.Array  # [N+1]
    h: jax.Array  # [N]


def to_batch_last(Z) -> BatchedTrajectory:
    """Convert a batch-leading Trajectory (leaves [B, ...]) to batch-last."""
    return BatchedTrajectory(
        X=jnp.moveaxis(Z.X, 0, -1),
        U=jnp.moveaxis(Z.U, 0, -1),
        t=Z.t[0] if Z.t.ndim == 2 else Z.t,
        h=Z.h[0] if Z.h.ndim == 2 else Z.h,
    )


def from_batch_last(Zb: BatchedTrajectory):
    from ..types import Trajectory

    B = Zb.X.shape[-1]
    return Trajectory(
        X=jnp.moveaxis(Zb.X, -1, 0),
        U=jnp.moveaxis(Zb.U, -1, 0),
        t=jnp.broadcast_to(Zb.t, (B,) + Zb.t.shape),
        h=jnp.broadcast_to(Zb.h, (B,) + Zb.h.shape),
    )


# ----------------------------------------------------------------- solver


class ALSolverBatched:
    """Throughput-oriented batched AL-iLQR.

    Any problem datum may vary per instance: `x0` as [n, B], and any cost /
    constraint / dynamics param leaf by carrying a TRAILING batch axis versus
    its canonical shape (goal refs [n] → [n, B], obstacle layouts
    [n_obs] → [n_obs, B], masses () → [B]; see `batch_axes`) — the batched
    replacement for the reference's loop over distinct problem objects
    (`perf/benchmark_unicycle.cpp:45-75`).  Every reference cone plus the
    SOC extension is handled (the cone algebra lives in `_al_terms` /
    `soc_project_bl` / `soc_jacobian_bl`, mirroring the reference's uniform
    cone handling, `constraint.hpp:28-122`).  Heterogeneous dynamics —
    multiple model families and/or per-knot dynamics params, the
    reference's distinct-model-per-knot container (`problem.hpp:159-183`)
    — run on the scan path via per-knot `lax.switch` dispatch and
    per-family Jacobian scatter (r4); a single shared `discretize()` family
    keeps the dispatch-free fast path and Pallas-kernel eligibility.
    Per-instance params run on the fused Pallas kernels too (read as lane
    vectors, specialized per signature — `ForwardKernel.param_sig`); only
    layouts the kernels cannot read (per-knot AND per-instance cost params
    on a partial knot range) fall back to the batch-last XLA scans.
    """

    def __init__(self, prob: CompiledProblem, opts: SolverOptions = None):
        self.prob = prob
        self.opts = opts or SolverOptions()
        # r4: heterogeneous dynamics supported on the scan path.  A single
        # shared family keeps the dispatch-free fast paths (the shipped
        # problems; also the Pallas-kernel eligibility condition); multiple
        # families / per-knot dynamics params route through the per-knot
        # `lax.switch` dispatch (`_dyn_step_k`) and per-family Jacobian
        # scatter (`dyn_jacobian_all`) — parity with the reference's
        # distinct-model-per-knot container (`problem.hpp:159-183`).
        self._dyn = prob.dynamics_families[0]
        self._dyn_single = (
            len(prob.dynamics_families) == 1
            and prob.dynamics_families[0].shared
        )
        if self.opts.backward_pass not in ("scan", "fused", "pscan"):
            raise ValueError(
                f"backward_pass={self.opts.backward_pass!r}: expected 'scan' "
                f"or 'fused'"
            )
        if self.opts.forward_pass not in ("scan", "pallas"):
            raise ValueError(
                f"forward_pass={self.opts.forward_pass!r}: expected 'scan' "
                f"or 'pallas'"
            )
        # The Pallas kernels compile through Triton on the GPU and run in
        # interpret mode on the CPU (the test route); on any other platform
        # `kernel_interpret` raises instead of falling back silently.
        self._fwd = None
        self._bwd = None
        if self.opts.forward_pass == "pallas" or self.opts.backward_pass == "fused":
            from ..ops.forward_pallas import kernel_interpret

            interpret = kernel_interpret()
            if self.opts.forward_pass == "pallas":
                from ..ops.forward_pallas import build_forward_kernel

                self._fwd = build_forward_kernel(
                    prob, self.opts, interpret=interpret
                )
            if self.opts.backward_pass == "fused":
                from ..ops.backward_fused_pallas import (
                    build_backward_fused_kernel,
                )

                self._bwd = build_backward_fused_kernel(
                    prob, self.opts, interpret=interpret
                )
        # Live fleet observability (`solver_logger.cpp:47-54` analog): at
        # verbose >= OUTER the outer loop emits one summary row per lockstep
        # outer iteration via jax.debug.callback (works under jit); at
        # INNER every lockstep inner iteration logs too.  SILENT (default)
        # adds nothing to the traced program.
        self._logger = None
        if self.opts.verbose > 0:
            from ..utils.logging import SolverLogger

            self._logger = SolverLogger(
                self.opts.verbose,
                frequency=self.opts.header_frequency,
                fleet=True,
            )
        if self.opts.matmul_precision:
            self.solve = with_matmul_precision(self.opts.matmul_precision)(
                self.solve
            )

    # ------------------------------------------------------ live observability
    def _live_inner_row(self, iters, active, cost_med, dJ_med, alpha_med, grad_med):
        lg = self._logger
        lg.log("iters", int(iters))
        lg.log("active", int(active))
        lg.log("cost_med", float(cost_med))
        lg.log("dJ_med", float(dJ_med))
        lg.log("alpha_med", float(alpha_med))
        lg.log("grad_med", float(grad_med))
        lg.print_row()

    def _live_outer_row(self, iter_al, iters, active, solved, viol, pen, grad):
        lg = self._logger
        lg.log("iter_al", int(iter_al))
        lg.log("iters", int(iters))
        lg.log("active", int(active))
        lg.log("solved", int(solved))
        lg.log("viol_max", float(viol))
        lg.log("pen_max", float(pen))
        lg.log("grad_med", float(grad))
        lg.print_row()

    def _emit_inner_row(self, active, stats: BatchedStats):
        if self._logger is None or not self._logger.active("cost_med"):
            return
        jax.debug.callback(
            self._live_inner_row,
            jnp.max(stats.iterations_total),
            jnp.sum(active),
            jnp.median(stats.cost),
            jnp.median(stats.cost_decrease),
            jnp.median(stats.alpha),
            jnp.median(stats.gradient),
            ordered=True,
        )

    def _emit_outer_row(self, active, status, stats: BatchedStats):
        if self._logger is None:
            return
        jax.debug.callback(
            self._live_outer_row,
            jnp.max(stats.iterations_outer),
            jnp.max(stats.iterations_total),
            jnp.sum(active),
            jnp.sum(status == jnp.int32(SolverStatus.SOLVED)),
            jnp.max(stats.violations),
            jnp.max(stats.max_penalty),
            jnp.median(stats.gradient),
            ordered=True,
        )

    def _use_kernel(self, kern, params: ProblemParams, Z: BatchedTrajectory) -> bool:
        if kern is None or Z.X.dtype != kern.dtype:
            return False
        # r4: per-instance (trailing-batch) cost/constraint/dynamics params
        # are read as lane vectors — the kernel specializes per signature
        # (`ForwardKernel.param_sig`).  Only layouts the kernel cannot
        # read (e.g. per-knot AND per-instance cost params on a partial
        # knot range) fall back to the XLA scans.
        from ..ops.forward_pallas import Ineligible

        try:
            kern.param_sig(params)
        except Ineligible:
            return False
        return True

    def _use_fwd(self, params: ProblemParams, Z: BatchedTrajectory) -> bool:
        return self._use_kernel(self._fwd, params, Z)

    def _fwd_rollout_cost(
        self, params, al_pad, Z, K, d, alpha, check_bounds, kern=None
    ):
        """Fused rollout + cost; returns (Zbar, valid, status, J)."""
        kern = self._fwd if kern is None else kern
        Bsz = Z.X.shape[-1]
        x0 = params.x0
        if x0.ndim == 1:
            x0 = jnp.broadcast_to(x0[:, None], (self.prob.n, Bsz))
        x0 = x0.astype(Z.X.dtype)
        Xn, Ubar, J, valid, status = kern(
            params, al_pad, Z, K, d, alpha, check_bounds=check_bounds
        )
        Zbar = dataclasses.replace(
            Z, X=jnp.concatenate([x0[None], Xn], axis=0), U=Ubar
        )
        return Zbar, valid, status, J

    # -------------------------------------------------------- model kernels
    def _cont_f_fam(self, fam, canon, fp, x, u, t):
        """Continuous dynamics, batch-last: x [n, B] -> xdot [n, B]."""
        fn = fam.model.continuous_fn
        return jax.vmap(
            fn, in_axes=(batch_axes(canon, fp), -1, -1, None), out_axes=-1
        )(fp, x, u, t)

    def _cont_jac_fam(self, fam, canon, fp, x, u, t):
        fn = fam.model.continuous_fn
        jac = jax.jacfwd(fn, argnums=(1, 2))
        A, Bc = jax.vmap(
            jac, in_axes=(batch_axes(canon, fp), -1, -1, None), out_axes=-1
        )(fp, x, u, t)
        return A, Bc  # [n, n, B], [n, m, B]

    def dyn_step_fam(self, fam, canon, fp, x, u, t, h):
        """One discrete step of one family, batch-last (x [n,B] -> [n,B])."""
        method = fam.model.method if fam.model is not None else None
        if method == "rk4":
            f = lambda p, x, u, t: self._cont_f_fam(fam, canon, p, x, u, t)
            k1 = f(fp, x, u, t)
            k2 = f(fp, x + 0.5 * h * k1, u, t + 0.5 * h)
            k3 = f(fp, x + 0.5 * h * k2, u, t + 0.5 * h)
            k4 = f(fp, x + h * k3, u, t + h)
            return x + h * (k1 + 2.0 * k2 + 2.0 * k3 + k4) / 6.0
        if method == "euler":
            return x + h * self._cont_f_fam(fam, canon, fp, x, u, t)
        # generic discrete fn fallback
        return jax.vmap(
            fam.fn,
            in_axes=(batch_axes(canon, fp), -1, -1, None, None),
            out_axes=-1,
        )(fp, x, u, t, h)

    def dyn_step(self, params, x, u, t, h):
        """Single-shared-family discrete step (the fast path's signature:
        `params` is that family's param pytree)."""
        return self.dyn_step_fam(
            self._dyn, self.prob.params.dynamics[0], params, x, u, t, h
        )

    def _dyn_step_k(self, params: ProblemParams, k, x, u, t, h):
        """Per-knot dynamics dispatch for heterogeneous problems: `k` is the
        traced segment index; families switch via the precomputed
        `dyn_fam_id` / `dyn_idx_in_fam` tables (`CompiledProblem`), with
        per-knot (stacked) family params row-extracted inside the branch."""
        fams = self.prob.dynamics_families
        ix = jnp.asarray(self.prob.dyn_idx_in_fam)[k]

        def make_branch(fam, canon, fp):
            def br(ixx):
                if fam.shared:
                    return self.dyn_step_fam(fam, canon, fp, x, u, t, h)
                canon_row = jax.tree_util.tree_map(lambda l: l[0], canon)
                fp_row = jax.tree_util.tree_map(lambda l: l[ixx], fp)
                return self.dyn_step_fam(fam, canon_row, fp_row, x, u, t, h)

            return br

        branches = [
            make_branch(fam, self.prob.params.dynamics[fj], params.dynamics[fj])
            for fj, fam in enumerate(fams)
        ]
        if len(branches) == 1:
            return branches[0](ix)
        fid = jnp.asarray(self.prob.dyn_fam_id)[k]
        return jax.lax.switch(fid, branches, ix)

    def _step_dispatch(self, params: ProblemParams, k, x, u, t, h):
        """Rollout step: dispatch-free for the single-shared-family case."""
        if self._dyn_single:
            return self.dyn_step(params.dynamics[0], x, u, t, h)
        return self._dyn_step_k(params, k, x, u, t, h)

    def _fam_jacobian(self, fam, canon, fp, X, U, t, h):
        """Discrete Jacobians A [K,n,n,B], Bd [K,n,m,B] over a knot subset
        of one family.

        Explicit RK4/Euler chain rule in batch-last einsums — identical math
        to `integration.hpp:132-169` (verified equal to AD of the step).
        Stacked (per-knot) family params map the outer knot vmap; shared
        params broadcast; per-instance trailing-batch leaves vmap inside
        (`batch_axes`).
        """
        n = X.shape[1]
        dt = X.dtype
        method = fam.model.method if fam.model is not None else None
        if fam.shared:
            canon_row, pax = canon, None
        else:
            canon_row = jax.tree_util.tree_map(lambda l: l[0], canon)
            pax = 0

        def cont_f(p, x, u, tt):
            return jax.vmap(
                fam.model.continuous_fn,
                in_axes=(batch_axes(canon_row, p), -1, -1, None),
                out_axes=-1,
            )(p, x, u, tt)

        def cont_jac_1(p, x, u, tt):
            jac = jax.jacfwd(fam.model.continuous_fn, argnums=(1, 2))
            return jax.vmap(
                jac,
                in_axes=(batch_axes(canon_row, p), -1, -1, None),
                out_axes=-1,
            )(p, x, u, tt)

        if method not in ("rk4", "euler"):
            # generic: AD of the discrete step, double-vmapped
            jac = jax.jacfwd(fam.fn, argnums=(1, 2))

            def jb(p, x, u, tt, hh):
                return jax.vmap(
                    jac,
                    in_axes=(batch_axes(canon_row, p), -1, -1, None, None),
                    out_axes=-1,
                )(p, x, u, tt, hh)

            return jax.vmap(jb, in_axes=(pax, 0, 0, 0, 0), out_axes=0)(
                fp, X, U, t, h
            )

        over = lambda fn: jax.vmap(fn, in_axes=(pax, 0, 0, 0), out_axes=0)
        cf = over(cont_f)
        cj = over(cont_jac_1)

        hk = h[:, None, None]  # for [K, n, B] ops
        hm = h[:, None, None, None]  # for [K, n, n, B] ops
        eye = jnp.eye(n, dtype=dt)[None, :, :, None]

        if method == "euler":
            Ac, Bc = cj(fp, X, U, t)
            return eye + Ac * hm, Bc * hm
        k1 = cf(fp, X, U, t)
        k2 = cf(fp, X + 0.5 * hk * k1, U, t + 0.5 * h)
        k3 = cf(fp, X + 0.5 * hk * k2, U, t + 0.5 * h)
        A1, B1 = cj(fp, X, U, t)
        A2, B2 = cj(fp, X + 0.5 * hk * k1, U, t + 0.5 * h)
        A3, B3 = cj(fp, X + 0.5 * hk * k2, U, t + 0.5 * h)
        A4, B4 = cj(fp, X + hk * k3, U, t + h)
        dA1 = A1 * hm
        dA2 = mm(A2, eye + 0.5 * dA1) * hm
        dA3 = mm(A3, eye + 0.5 * dA2) * hm
        dA4 = mm(A4, eye + dA3) * hm
        A = eye + (dA1 + 2 * dA2 + 2 * dA3 + dA4) / 6.0
        dB1 = B1 * hm
        dB2 = B2 * hm + 0.5 * mm(A2, dB1) * hm
        dB3 = B3 * hm + 0.5 * mm(A3, dB2) * hm
        dB4 = B4 * hm + mm(A4, dB3) * hm
        Bd = (dB1 + 2 * dB2 + 2 * dB3 + dB4) / 6.0
        return A, Bd

    def dyn_jacobian_all(self, params: ProblemParams, Z: BatchedTrajectory):
        """Discrete Jacobians A [N,n,n,B], Bd [N,n,m,B] for all segments.

        Heterogeneous problems compute each family's Jacobians on its own
        (static) knot subset and scatter into the full arrays — knot-point
        parallelism per family, no per-step dispatch.
        """
        fams = self.prob.dynamics_families
        if self._dyn_single:
            return self._fam_jacobian(
                fams[0], self.prob.params.dynamics[0], params.dynamics[0],
                Z.X[:-1], Z.U, Z.t[:-1], Z.h,
            )
        N = Z.U.shape[0]
        n = Z.X.shape[1]
        m = Z.U.shape[1]
        Bsz = Z.X.shape[-1]
        dt = Z.X.dtype
        A = jnp.zeros((N, n, n, Bsz), dt)
        Bd = jnp.zeros((N, n, m, Bsz), dt)
        for fj, fam in enumerate(fams):
            ks = fam.knots  # static indices
            Af, Bf = self._fam_jacobian(
                fam, self.prob.params.dynamics[fj], params.dynamics[fj],
                Z.X[ks], Z.U[ks], Z.t[ks], Z.h[ks],
            )
            A = A.at[ks].set(Af)
            Bd = Bd.at[ks].set(Bf)
        return A, Bd

    # ------------------------------------------------------- cost kernels
    def _upad(self, Z: BatchedTrajectory):
        zrow = jnp.zeros((1,) + Z.U.shape[1:], Z.U.dtype)
        return jnp.concatenate([Z.U, zrow], axis=0)

    def _family_xu(self, fam, Z: BatchedTrajectory):
        return Z.X[fam.knots], self._upad(Z)[fam.knots]

    def _quad_terms(self, fp, canon, Xk, Uk, want_expansion):
        """Closed-form quadratic cost family, batch-last.

        J = ½xᵀQx + xᵀHu + ½uᵀRu + qᵀx + rᵀu + c (`quadratic_cost.cpp:8-28`).
        Param shapes: shared [n,n], per-knot [nk,n,n], and either with a
        trailing per-instance batch axis ([..., B], see `batch_axes`);
        `canon` is the canonical (unbatched) param pytree used to tell the
        layouts apart.
        """
        nk, n, Bsz = Xk.shape
        m = Uk.shape[1]

        def norm(name, core_nd):
            # normalize to broadcastable [NK, *core, BB] with NK∈{1,nk},
            # BB∈{1,B}
            leaf = jnp.asarray(fp[name])
            if leaf.ndim != jnp.ndim(canon[name]) + 1:
                leaf = leaf[..., None]  # not per-instance
            if leaf.ndim != core_nd + 2:
                leaf = leaf[None]  # not per-knot
            return leaf

        Q = norm("Q", 2)
        R = norm("R", 2)
        H = norm("H", 2)
        q = norm("q", 1)
        r = norm("r", 1)
        c = norm("c", 0)

        def matvec(Mat, V):
            # Mat [NK,i,j,BB]; V [nk,j,B] -> [nk,i,B]; broadcast-reduce over
            # the tiny contraction axis (see mm() for why not einsum)
            return (Mat * V[:, None, :, :]).sum(axis=2)

        def vdot(vec, V):
            return (vec * V).sum(axis=1)

        Qx = matvec(Q, Xk)
        Ru = matvec(R, Uk)
        Hu = matvec(H, Uk)
        Htx = matvec(jnp.swapaxes(H, 1, 2), Xk)
        J = (
            0.5 * dotv(Xk, Qx)
            + dotv(Xk, Hu)
            + 0.5 * dotv(Uk, Ru)
            + vdot(q, Xk)
            + vdot(r, Uk)
            + c
        )
        if not want_expansion:
            return J, None

        def bc(Mat):
            return jnp.broadcast_to(Mat, (nk,) + Mat.shape[1:3] + (Bsz,))

        lx = Qx + Hu + q
        lu = Ru + Htx + r
        return J, (lx, lu, bc(Q), bc(H), bc(R))

    def _generic_cost_terms(self, fam, fp, canon, Xk, Uk, want_expansion):
        """Fallback for arbitrary cost fns: AD expansion, double-vmapped.

        Per-instance param leaves (trailing batch axis vs `canon`) vmap over
        the batch with the states; shared leaves broadcast.
        """
        from ..problem.costs import ad_expansion

        def one(p, x, u):
            if want_expansion:
                t = (
                    fam.expand_fn(p, x, u)
                    if fam.expand_fn is not None
                    else ad_expansion(fam.fn, p, x, u)
                )
                return t.J, t.lx, t.lu, t.lxx, t.lxu, t.luu
            return (fam.fn(p, x, u),)

        inner = jax.vmap(one, in_axes=(batch_axes(canon, fp), -1, -1), out_axes=-1)
        if fam.shared:
            outer = jax.vmap(inner, in_axes=(None, 0, 0), out_axes=0)
        else:
            outer = jax.vmap(inner, in_axes=(0, 0, 0), out_axes=0)
        out = outer(fp, Xk, Uk)
        if want_expansion:
            J, lx, lu, lxx, lxu, luu = out
            return J, (lx, lu, lxx, lxu, luu)
        return out[0], None

    def _con_values(self, fam, fp, canon, Xk, Uk):
        """Constraint values [nk, p, B] via double vmap."""
        inner = jax.vmap(
            fam.fn, in_axes=(batch_axes(canon, fp), -1, -1), out_axes=-1
        )
        if fam.shared:
            return jax.vmap(inner, in_axes=(None, 0, 0), out_axes=0)(fp, Xk, Uk)
        return jax.vmap(inner, in_axes=(0, 0, 0), out_axes=0)(fp, Xk, Uk)

    def _con_jacs(self, fam, fp, canon, Xk, Uk):
        """Constraint Jacobians ([nk,p,n,B], [nk,p,m,B])."""
        jfn = fam.jac_fn
        if jfn is None:
            jfn = lambda p, x, u: jax.jacfwd(fam.fn, argnums=(1, 2))(p, x, u)
        inner = jax.vmap(
            jfn, in_axes=(batch_axes(canon, fp), -1, -1), out_axes=-1
        )
        if fam.shared:
            return jax.vmap(inner, in_axes=(None, 0, 0), out_axes=0)(fp, Xk, Uk)
        return jax.vmap(inner, in_axes=(0, 0, 0), out_axes=0)(fp, Xk, Uk)

    def _al_terms(self, fam, c, Cx, Cu, lam, rho, want_expansion):
        """AL value/grad/Hessian, batch-last (`constraint_values.hpp:111-177`).

        lam [nk, p, B], rho [nk, B].
        """
        dual = dual_cone(fam.cone)
        s = lam - rho[:, None, :] * c
        dproj = None
        if dual is Cone.ZERO:
            lam_proj = jnp.zeros_like(s)
            dproj = jnp.zeros_like(s)
        elif dual is Cone.IDENTITY:
            lam_proj = s
            dproj = jnp.ones_like(s)
        elif dual is Cone.SECOND_ORDER:
            lam_proj = soc_project_bl(s)
        else:
            lam_proj = jnp.minimum(s, 0.0)
            dproj = jnp.where(s > 0, 0.0, 1.0).astype(s.dtype)
        J = (jnp.sum(lam_proj * lam_proj, axis=1) - jnp.sum(lam * lam, axis=1)) / (
            2.0 * rho
        )
        if not want_expansion:
            return J, None
        if dproj is not None:  # diagonal projection Jacobian
            Jpx = dproj[:, :, None, :] * Cx
            Jpu = dproj[:, :, None, :] * Cu
        else:  # SOC: dense p×p projection Jacobian (`cone_jacobian`)
            Jp = soc_jacobian_bl(s)
            Jpx = mm(Jp, Cx)
            Jpu = mm(Jp, Cu)
        # contractions over the small p axis as broadcast-multiply-reduce
        # (see mm() for why not einsum)
        gx = -(lam_proj[:, :, None, :] * Jpx).sum(axis=1)
        gu = -(lam_proj[:, :, None, :] * Jpu).sum(axis=1)
        rb = rho[:, None, None, :]

        def gram(Ja, Jb):
            return (Ja[:, :, :, None, :] * Jb[:, :, None, :, :]).sum(axis=1)

        Hxx = rb * gram(Jpx, Jpx)
        Hxu = rb * gram(Jpx, Jpu)
        Huu = rb * gram(Jpu, Jpu)
        return J, (gx, gu, Hxx, Hxu, Huu)

    # --------------------------------------------------------- assembled ops
    def cost_terms(self, params: ProblemParams, al, Z: BatchedTrajectory):
        """Per-knot AL cost [N+1, B]."""
        N = self.prob.N
        Bsz = Z.X.shape[-1]
        costs = jnp.zeros((N + 1, Bsz), Z.X.dtype)
        canon = self.prob.params
        for fam, fp, cp in zip(self.prob.cost_families, params.costs, canon.costs):
            Xk, Uk = self._family_xu(fam, Z)
            if fam.fn is _quadcost_eval:
                J, _ = self._quad_terms(fp, cp, Xk, Uk, False)
            else:
                J, _ = self._generic_cost_terms(fam, fp, cp, Xk, Uk, False)
            costs = costs.at[fam.knots].add(J)
        for fam, fp, cp, st in zip(
            self.prob.constraint_families, params.constraints,
            canon.constraints, al,
        ):
            Xk, Uk = self._family_xu(fam, Z)
            c = self._con_values(fam, fp, cp, Xk, Uk)
            J, _ = self._al_terms(fam, c, None, None, st["lam"], st["rho"], False)
            costs = costs.at[fam.knots].add(J)
        return costs

    def total_cost(self, params, al, Z):
        return self.cost_terms(params, al, Z).sum(axis=0)  # [B]

    def expand(self, params: ProblemParams, al, Z: BatchedTrajectory):
        """All expansions, batch-last."""
        prob = self.prob
        N, n, m = prob.N, prob.n, prob.m
        Bsz = Z.X.shape[-1]
        dt = Z.X.dtype
        costs = jnp.zeros((N + 1, Bsz), dt)
        lx = jnp.zeros((N + 1, n, Bsz), dt)
        lu = jnp.zeros((N + 1, m, Bsz), dt)
        lxx = jnp.zeros((N + 1, n, n, Bsz), dt)
        lxu = jnp.zeros((N + 1, n, m, Bsz), dt)
        luu = jnp.zeros((N + 1, m, m, Bsz), dt)
        canon = prob.params
        for fam, fp, cp in zip(prob.cost_families, params.costs, canon.costs):
            Xk, Uk = self._family_xu(fam, Z)
            if fam.fn is _quadcost_eval:
                J, exp = self._quad_terms(fp, cp, Xk, Uk, True)
            else:
                J, exp = self._generic_cost_terms(fam, fp, cp, Xk, Uk, True)
            glx, glu, glxx, glxu, gluu = exp
            ks = fam.knots
            costs = costs.at[ks].add(J)
            lx = lx.at[ks].add(glx)
            lu = lu.at[ks].add(glu)
            lxx = lxx.at[ks].add(glxx)
            lxu = lxu.at[ks].add(glxu)
            luu = luu.at[ks].add(gluu)
        for fam, fp, cp, st in zip(
            prob.constraint_families, params.constraints, canon.constraints, al
        ):
            Xk, Uk = self._family_xu(fam, Z)
            c = self._con_values(fam, fp, cp, Xk, Uk)
            Cx, Cu = self._con_jacs(fam, fp, cp, Xk, Uk)
            J, exp = self._al_terms(fam, c, Cx, Cu, st["lam"], st["rho"], True)
            gx, gu, Hxx, Hxu, Huu = exp
            ks = fam.knots
            costs = costs.at[ks].add(J)
            lx = lx.at[ks].add(gx)
            lu = lu.at[ks].add(gu)
            lxx = lxx.at[ks].add(Hxx)
            lxu = lxu.at[ks].add(Hxu)
            luu = luu.at[ks].add(Huu)
        A, Bd = self.dyn_jacobian_all(params, Z)
        return dict(costs=costs, lx=lx, lu=lu, lxx=lxx, lxu=lxu, luu=luu, A=A, B=Bd)

    # ------------------------------------------------------------- backward
    def riccati_scan(self, exp, rho):
        """Sequential Riccati sweep, batch-last; rho [B].

        Same recursion as `riccati._riccati_scan` with per-instance failure
        masks.
        """
        N = exp["A"].shape[0]
        m = exp["B"].shape[2]
        dt = exp["A"].dtype
        Bsz = exp["A"].shape[-1]
        PN = exp["lxx"][N]
        pN = exp["lx"][N]
        eye_m = jnp.eye(m, dtype=dt)[:, :, None]

        def step(carry, inp):
            P, p, dV1, dV2, failed = carry
            A, Bd, lxx, lxu, luu, lx, lu = inp
            AtP = mm(mT(A), P)
            Qxx = lxx + mm(AtP, A)
            Qxu = lxu + mm(AtP, Bd)
            Quu = luu + mm(mT(Bd), mm(P, Bd))
            Qx = lx + mv(mT(A), p)
            Qu = lu + mv(mT(Bd), p)
            Quu_reg = Quu + eye_m * rho
            L = chol_unrolled(Quu_reg)
            fail_k = chol_failed(L)
            safe = [
                [
                    None if e is None else jnp.where(jnp.isfinite(e), e, 1.0)
                    for e in row
                ]
                for row in L
            ]
            K = -chol_solve_mat(safe, mT(Qxu))
            d = -chol_solve_vec(safe, Qu)
            # gain-magnitude guard (SolverOptions.bp_gain_limit): a finite-
            # but-singular factorization yields unbounded gains; count it
            # as failure so the retry loop regularizes instead of the
            # forward pass hard-aborting on a diverged rollout
            glim = self.opts.bp_gain_limit
            fail_k = fail_k | ~(
                jnp.max(jnp.abs(K), axis=(0, 1)) <= glim
            ) | ~(jnp.max(jnp.abs(d), axis=0) <= glim)
            KtQuu = mm(mT(K), Quu)
            p_new = Qx + mv(KtQuu, d) + mv(mT(K), Qu) + mv(Qxu, d)
            P_new = Qxx + mm(KtQuu, K) + mm(mT(K), mT(Qxu)) + mm(Qxu, K)
            dV1_new = dV1 + dotv(d, Qu)
            dV2_new = dV2 + 0.5 * dotv(d, mv(Quu, d))
            new_failed = failed | fail_k
            P = bwhere(new_failed, P, P_new)
            p = bwhere(new_failed, p, p_new)
            dV1 = bwhere(new_failed, dV1, dV1_new)
            dV2 = bwhere(new_failed, dV2, dV2_new)
            return (P, p, dV1, dV2, new_failed), (K, d)

        zero = jnp.zeros((Bsz,), dt)
        init = (PN, pN, zero, zero, jnp.zeros((Bsz,), bool))
        xs = (
            exp["A"], exp["B"], exp["lxx"][:N], exp["lxu"][:N],
            exp["luu"][:N], exp["lx"][:N], exp["lu"][:N],
        )
        (P0, p0, dV1, dV2, failed), (K, d) = jax.lax.scan(
            step, init, xs, reverse=True, unroll=self.opts.scan_unroll
        )
        return K, d, dV1, dV2, failed

    def backward_pass_fused(self, params, al_pad, Z, rho, drho, kern=None):
        """Backward pass via the fused expansion+Riccati kernel
        (`ops/backward_fused_pallas.py`): no materialized expansions, and
        the trajectory's AL cost J0 comes out of the same pass.  Same
        retry-with-regularization semantics as :meth:`backward_pass`."""
        kern = self._bwd if kern is None else kern
        opts = self.opts
        N, n, m = self.prob.N, self.prob.n, self.prob.m
        Bsz = Z.X.shape[-1]
        dt = Z.X.dtype

        def cond(c):
            return ~jnp.all(c["done"])

        def body(c):
            K, d, dV1, dV2, failed, J0 = kern(params, al_pad, Z, c["rho"])
            rho2, drho2 = _increase_reg(c["rho"], c["drho"], opts)
            rho_n = bwhere(failed, rho2, c["rho"])
            drho_n = bwhere(failed, drho2, c["drho"])
            count = c["count"] + jnp.where(
                failed & (rho_n >= opts.bp_reg_max), 1, 0
            )
            give_up = failed & (count >= opts.bp_reg_fail_threshold)
            done = (~failed) | give_up
            return dict(
                K=K, d=d, dV1=dV1, dV2=dV2, failed=failed, J0=J0,
                rho=rho_n, drho=drho_n, count=count, done=done,
            )

        init = dict(
            K=jnp.zeros((N, m, n, Bsz), dt),
            d=jnp.zeros((N, m, Bsz), dt),
            dV1=jnp.zeros((Bsz,), dt),
            dV2=jnp.zeros((Bsz,), dt),
            failed=jnp.ones((Bsz,), bool),
            J0=jnp.zeros((Bsz,), dt),
            rho=rho, drho=drho,
            count=jnp.zeros((Bsz,), jnp.int32),
            done=jnp.zeros((Bsz,), bool),
        )
        return jax.lax.while_loop(cond, body, init)

    def backward_pass(self, exp, rho, drho):
        """Retry loop with per-instance regularization (`ilqr.hpp:385-445`).

        The sweep is `riccati_scan` (XLA lax.scan).  With
        `opts.backward_pass == "fused"` the expansions run inside the sweep
        kernel instead (`ops/backward_fused_pallas.py`, selected in
        :meth:`ilqr_solve`); this method is then its ineligible-problem
        fallback.  "pscan" (associative-scan parallel Riccati,
        `solver/pscan_batched.py`) was retired as an option in r5 — see
        SolverOptions.backward_pass.
        """
        opts = self.opts
        if opts.backward_pass == "pscan":
            raise ValueError(
                "backward_pass='pscan' was retired in r5 (measured slower "
                "than the sequential sweep everywhere - PARITY.md); use "
                "solver.pscan_batched.riccati_pscan_batched directly for "
                "research"
            )
        else:
            sweep = self.riccati_scan
        N = exp["A"].shape[0]
        n, m = self.prob.n, self.prob.m
        Bsz = exp["A"].shape[-1]
        dt = exp["A"].dtype

        def cond(c):
            return ~jnp.all(c["done"])

        def body(c):
            K, d, dV1, dV2, failed = sweep(exp, c["rho"])
            rho2, drho2 = _increase_reg(c["rho"], c["drho"], opts)
            rho_n = bwhere(failed, rho2, c["rho"])
            drho_n = bwhere(failed, drho2, c["drho"])
            count = c["count"] + jnp.where(
                failed & (rho_n >= opts.bp_reg_max), 1, 0
            )
            give_up = failed & (count >= opts.bp_reg_fail_threshold)
            done = (~failed) | give_up
            return dict(
                K=K, d=d, dV1=dV1, dV2=dV2, failed=failed,
                rho=rho_n, drho=drho_n, count=count, done=done,
            )

        init = dict(
            K=jnp.zeros((N, m, n, Bsz), dt),
            d=jnp.zeros((N, m, Bsz), dt),
            dV1=jnp.zeros((Bsz,), dt),
            dV2=jnp.zeros((Bsz,), dt),
            failed=jnp.ones((Bsz,), bool),
            rho=rho, drho=drho,
            count=jnp.zeros((Bsz,), jnp.int32),
            done=jnp.zeros((Bsz,), bool),
        )
        out = jax.lax.while_loop(cond, body, init)
        return out

    # ------------------------------------------------------------- forward
    def rollout(self, params: ProblemParams, Z: BatchedTrajectory):
        x0 = params.x0
        if x0.ndim == 1:
            x0 = jnp.broadcast_to(x0[:, None], (self.prob.n, Z.X.shape[-1]))
        x0 = x0.astype(Z.X.dtype)

        def step(x, inp):
            k, u, t, h = inp
            xn = self._step_dispatch(params, k, x, u, t, h)
            return xn, xn

        N = Z.U.shape[0]
        _, Xn = jax.lax.scan(
            step, x0, (jnp.arange(N), Z.U, Z.t[:-1], Z.h),
            unroll=self.opts.scan_unroll,
        )
        return dataclasses.replace(Z, X=jnp.concatenate([x0[None], Xn], axis=0))

    def closed_loop_rollout(self, params, Z: BatchedTrajectory, K, d, alpha):
        """Feedback rollout with per-instance alpha [B] (`ilqr.hpp:468-499`)."""
        opts = self.opts
        Bsz = Z.X.shape[-1]
        x0 = params.x0
        if x0.ndim == 1:
            x0 = jnp.broadcast_to(x0[:, None], (self.prob.n, Bsz))
        x0 = x0.astype(Z.X.dtype)
        unsolved = jnp.full((Bsz,), SolverStatus.UNSOLVED, jnp.int32)

        def step(carry, inp):
            xbar, valid, status = carry
            k, x_k, u_k, K_k, d_k, t_k, h_k = inp
            ubar = u_k + mv(K_k, xbar - x_k) + alpha * d_k
            xnext = self._step_dispatch(params, k, xbar, ubar, t_k, h_k)
            if opts.check_forwardpass_bounds:
                state_ok = jnp.sqrt(jnp.sum(xnext * xnext, axis=0)) <= opts.state_max
                ctrl_ok = jnp.sqrt(jnp.sum(ubar * ubar, axis=0)) <= opts.control_max
            else:
                state_ok = jnp.ones((Bsz,), bool)
                ctrl_ok = state_ok
            step_ok = state_ok & ctrl_ok
            fail_now = valid & ~step_ok
            status = jnp.where(
                fail_now,
                jnp.where(
                    ~state_ok,
                    jnp.int32(SolverStatus.STATE_LIMIT),
                    jnp.int32(SolverStatus.CONTROL_LIMIT),
                ),
                status,
            )
            new_valid = valid & step_ok
            xkeep = bwhere(new_valid, xnext, xbar)
            return (xkeep, new_valid, status), (xkeep, ubar)

        init = (x0, jnp.ones((Bsz,), bool), unsolved)
        Nseg = Z.U.shape[0]
        (xf, valid, status), (Xn, Ubar) = jax.lax.scan(
            step, init, (jnp.arange(Nseg), Z.X[:-1], Z.U, K, d, Z.t[:-1], Z.h),
            unroll=self.opts.scan_unroll,
        )
        status = jnp.where(valid, unsolved, status)
        Zb = dataclasses.replace(
            Z, X=jnp.concatenate([x0[None], Xn], axis=0), U=Ubar
        )
        return Zb, valid, status

    def _line_search_speculative(self, params, al_pad, Z, bp, J0, S, kern=None):
        """Speculative (parallel) backtracking line search.

        The sequential search is lockstep across the batch: the while_loop
        runs until the SLOWEST instance's α settles, so one instance needing
        k halvings makes all B instances pay k fused rollout+cost rounds.
        Instead evaluate S candidates α·(1, ½, …, ½^(S-1)) in ONE kernel
        call at S× lane width and accept the FIRST
        passing candidate per instance — the same α the sequential halving
        sequence (`ilqr.hpp:525-545`) would accept, at ~fixed cost per inner
        iteration.  Rounds repeat (α scaled by ½^S) only if some instance
        rejects all S candidates.

        Returns the same carry dict as the sequential while_loop in
        :meth:`forward_pass`.
        """
        opts = self.opts
        dt = Z.X.dtype
        Bsz = Z.X.shape[-1]
        N, n, m = self.prob.N, self.prob.n, self.prob.m
        max_it = opts.line_search_max_iterations
        inv_f = 1.0 / opts.line_search_decrease_factor

        def tile(leaf):
            return jnp.tile(leaf, (1,) * (leaf.ndim - 1) + (S,))

        # Candidate-major lane tiling: segment j of the widened batch holds
        # candidate α_j for every instance.  The base trajectory / gains /
        # AL state are fixed for the whole line search, so tile them once.
        Z_s = dataclasses.replace(Z, X=tile(Z.X), U=tile(Z.U))
        K_s, d_s = tile(bp["K"]), tile(bp["d"])
        al_pad_s = jax.tree_util.tree_map(tile, al_pad)
        # EVERY per-instance (trailing-batch) param leaf must widen with
        # the lanes — x0, and any batched cost/constraint/dynamics data
        # (the `batch_axes` convention); shared leaves stay as they are
        params_s = jax.tree_util.tree_map(
            lambda c, l: (
                tile(l) if jnp.ndim(l) == jnp.ndim(c) + 1 else l
            ),
            self.prob.params,
            params,
        )
        facs = (inv_f ** jnp.arange(S, dtype=dt))[:, None]  # [S, 1]
        cand = jnp.arange(S, dtype=jnp.int32)[:, None]  # [S, 1]

        def cond(c):
            return jnp.any((~c["success"]) & (c["it"] < max_it))

        def body(c):
            active = (~c["success"]) & (c["it"] < max_it)
            alphas = c["alpha"][None, :] * facs  # [S, B]
            Zbar_s, valid_s, status_s, J_s = self._fwd_rollout_cost(
                params_s, al_pad_s, Z_s, K_s, d_s,
                alphas.reshape(S * Bsz), opts.check_forwardpass_bounds,
                kern=kern,
            )
            J_c = J_s.reshape(S, Bsz)
            valid = valid_s.reshape(S, Bsz)
            status_c = status_s.reshape(S, Bsz)
            expected = -alphas * (bp["dV1"][None, :] + alphas * bp["dV2"][None, :])
            z = jnp.where(
                expected > 0.0, (J0[None, :] - J_c) / expected, -jnp.ones((), dt)
            )
            # candidate j is only a real try if the sequential search would
            # still be within its iteration budget at try it+j
            tried = (c["it"][None, :] + cand) < max_it
            ok = (
                valid
                & (opts.line_search_lower_bound <= z)
                & (z <= opts.line_search_upper_bound)
                & (J_c < J0[None, :])
                & tried
            )
            any_ok = jnp.any(ok, axis=0)
            first_ok = jnp.argmax(ok, axis=0).astype(jnp.int32)  # first True
            n_tried = tried.sum(axis=0).astype(jnp.int32)  # [B]
            last_idx = jnp.maximum(n_tried - 1, 0)
            sel = jnp.where(any_ok, first_ok, last_idx)  # [B]
            pick = cand == sel[None, :]  # [S, B]

            def sel_sb(arr, fill):
                return jnp.where(pick, arr, fill).sum(axis=0)

            J_sel = sel_sb(J_c, 0.0)
            z_sel = sel_sb(z, 0.0)
            status_sel = sel_sb(status_c, 0).astype(jnp.int32)
            alpha_sel = sel_sb(alphas, 0.0)
            valid_sel = jnp.any(pick & valid, axis=0)
            pk = pick[None, None]  # for [N?, dim, S, B] selects

            def sel_Z(leaf):
                r = leaf.reshape(leaf.shape[:-1] + (S, Bsz))
                return jnp.where(pk, r, 0.0).sum(axis=-2)

            Zbar = dataclasses.replace(
                Z, X=sel_Z(Zbar_s.X), U=sel_Z(Zbar_s.U)
            )
            newc = dict(c)
            newc["it"] = c["it"] + jnp.where(
                active, jnp.where(any_ok, first_ok + 1, n_tried), 0
            )
            newc["success"] = jnp.where(active, any_ok, c["success"])
            newc["alpha"] = jnp.where(
                active,
                jnp.where(
                    any_ok,
                    alpha_sel,
                    c["alpha"] * inv_f ** n_tried.astype(dt),
                ),
                c["alpha"],
            )
            newc["J"] = jnp.where(
                active, jnp.where(valid_sel, J_sel, c["J"]), c["J"]
            )
            newc["z"] = jnp.where(active, z_sel, c["z"])
            newc["status"] = jnp.where(active, status_sel, c["status"])
            newc["Zbar"] = zselect(active, Zbar, c["Zbar"])
            return newc

        init = dict(
            it=jnp.zeros((Bsz,), jnp.int32),
            alpha=jnp.ones((Bsz,), dt),
            success=jnp.zeros((Bsz,), bool),
            J=J0,
            z=-jnp.ones((Bsz,), dt),
            status=jnp.full((Bsz,), SolverStatus.UNSOLVED, jnp.int32),
            Zbar=Z,
        )
        return jax.lax.while_loop(cond, body, init)

    def forward_pass(
        self, params, al, Z, bp, J0, rho=None, drho=None, al_pad=None,
        fwd_kern=None,
    ):
        """Per-instance backtracking line search (`ilqr.hpp:512-558`).

        `rho`/`drho` are the post-decrease regularization (see the
        per-instance solver); failure increases from there.  `al_pad` is the
        padded AL state for the fused Pallas forward kernel (built once per
        inner solve by `ilqr_solve`); None selects the XLA scan path.  With
        the Pallas kernel and `line_search_parallel > 1`, candidate step
        sizes are evaluated speculatively in one widened kernel call (see
        :meth:`_line_search_speculative`).
        """
        opts = self.opts
        dt = Z.X.dtype
        Bsz = Z.X.shape[-1]
        rho = bp["rho"] if rho is None else rho
        drho = bp["drho"] if drho is None else drho
        S = int(opts.line_search_parallel)
        if al_pad is not None and S > 1:
            c = self._line_search_speculative(
                params, al_pad, Z, bp, J0, S, kern=fwd_kern
            )
            return self._forward_finish(c, Z, J0, rho, drho, opts)

        def cond(c):
            return jnp.any((~c["success"]) & (c["it"] < opts.line_search_max_iterations))

        def body(c):
            active = (~c["success"]) & (c["it"] < opts.line_search_max_iterations)
            if al_pad is not None:
                Zbar, valid, status, J_try = self._fwd_rollout_cost(
                    params, al_pad, Z, bp["K"], bp["d"], c["alpha"],
                    opts.check_forwardpass_bounds, kern=fwd_kern,
                )
            else:
                Zbar, valid, status = self.closed_loop_rollout(
                    params, Z, bp["K"], bp["d"], c["alpha"]
                )
                J_try = self.total_cost(params, al, Zbar)
            J = jnp.where(valid, J_try, c["J"])
            expected = -c["alpha"] * (bp["dV1"] + c["alpha"] * bp["dV2"])
            z = jnp.where(expected > 0.0, (J0 - J_try) / expected, -jnp.ones((), dt))
            ok = (
                valid
                & (opts.line_search_lower_bound <= z)
                & (z <= opts.line_search_upper_bound)
                & (J_try < J0)
            )
            # only active instances update
            newc = dict(c)
            newc["it"] = c["it"] + jnp.where(active, 1, 0)
            newc["success"] = jnp.where(active, ok, c["success"])
            newc["alpha"] = jnp.where(
                active & ~ok, c["alpha"] / opts.line_search_decrease_factor, c["alpha"]
            )
            newc["J"] = jnp.where(active, J, c["J"])
            newc["z"] = jnp.where(active, z, c["z"])
            newc["status"] = jnp.where(active, status, c["status"])
            newc["Zbar"] = zselect(active, Zbar, c["Zbar"])
            return newc

        init = dict(
            it=jnp.zeros((Bsz,), jnp.int32),
            alpha=jnp.ones((Bsz,), dt),
            success=jnp.zeros((Bsz,), bool),
            J=J0,
            z=-jnp.ones((Bsz,), dt),
            status=jnp.full((Bsz,), SolverStatus.UNSOLVED, jnp.int32),
            Zbar=Z,
        )
        c = jax.lax.while_loop(cond, body, init)
        return self._forward_finish(c, Z, J0, rho, drho, opts)

    @staticmethod
    def _forward_finish(c, Z, J0, rho, drho, opts):
        """Shared line-search epilogue (accept/reject + reg update)."""
        Z_out = zselect(c["success"], c["Zbar"], Z)
        rho_i, drho_i = _increase_reg(rho, drho, opts)
        rho = jnp.where(c["success"], rho, rho_i)
        drho = jnp.where(c["success"], drho, drho_i)
        J_final = jnp.where(c["success"], c["J"], J0)
        status = jnp.where(
            J_final > J0, jnp.int32(SolverStatus.COST_INCREASE), c["status"]
        )
        return dict(
            Z=Z_out, J=J_final, alpha=c["alpha"], z=c["z"],
            success=c["success"], rho=rho, drho=drho, status=status,
        )

    # ------------------------------------------------------------- inner solve
    def ilqr_solve(
        self, params, al, Z, stats: BatchedStats, outer_active, lane_opts=None
    ):
        """Masked batched inner solve; `outer_active` [B] gates instances.

        `lane_opts` (optional dict of [B] arrays) overrides
        `max_iterations_total` per lane — see :meth:`solve`.
        """
        opts = self.opts
        lane_opts = lane_opts or {}
        max_total = lane_opts.get(
            "max_iterations_total", opts.max_iterations_total
        )
        dt = Z.X.dtype
        Bsz = Z.X.shape[-1]
        N, n, m = self.prob.N, self.prob.n, self.prob.m

        fwd = self._fwd
        bwd = self._bwd
        use_bwd_fused = self._use_kernel(bwd, params, Z)
        al_pad = None
        al_pad_bwd = None
        if use_bwd_fused:
            al_pad_bwd = bwd.pad_al(al)
        use_fwd = self._use_kernel(fwd, params, Z)
        if use_fwd:
            al_pad = fwd.pad_al(al) if al_pad_bwd is None else al_pad_bwd
            zK = jnp.zeros((N, m, n, Bsz), dt)
            zd = jnp.zeros((N, m, Bsz), dt)
            # K=d=α=0 makes the fused kernel the open-loop rollout + cost
            # (unguarded, like the reference's Rollout, `ilqr.hpp:453-459`)
            Zro, _, _, J_ro = self._fwd_rollout_cost(
                params, al_pad, Z, zK, zd, jnp.zeros((Bsz,), dt), False,
                kern=fwd,
            )
            Z = zselect(outer_active, Zro, Z)
            J_init = J_ro
        else:
            Z = zselect(outer_active, self.rollout(params, Z), Z)
            J_init = self.total_cost(params, al, Z)
        stats = stats.replace(
            initial_cost=jnp.where(outer_active, J_init, stats.initial_cost),
            iterations_inner=jnp.where(outer_active, 0, stats.iterations_inner),
        )

        def cond(c):
            return jnp.any(~c["done"])

        def body(c):
            active = ~c["done"]
            stats: BatchedStats = c["stats"]
            if use_bwd_fused:
                # expansions computed inside the sweep; J0 falls out of the
                # same kernel's Kahan cost accumulation
                bp = self.backward_pass_fused(
                    params, al_pad_bwd, c["Z"], c["rho"], c["drho"], kern=bwd
                )
                J0 = bp["J0"]
            else:
                exp = self.expand(params, al, c["Z"])
                J0 = exp["costs"].sum(axis=0)
                bp = self.backward_pass(exp, c["rho"], c["drho"])
            rho_d, drho_d = _decrease_reg(bp["rho"], bp["drho"], opts)
            fp = self.forward_pass(
                params, al, c["Z"], bp, J0, rho_d, drho_d, al_pad,
                fwd_kern=fwd,
            )
            bp_failed = bp["failed"]
            status = jnp.where(
                bp_failed,
                jnp.int32(SolverStatus.BACKWARD_PASS_REGULARIZATION_FAILED),
                fp["status"],
            )
            cost_new = jnp.where(fp["success"], fp["J"], c["cost_last"])
            grad = jnp.mean(
                jnp.max(jnp.abs(bp["d"]) / (jnp.abs(fp["Z"].U) + 1.0), axis=1),
                axis=0,
            )
            dJ = c["cost_last"] - cost_new
            inner = stats.iterations_inner + jnp.where(active, 1, 0)
            total = stats.iterations_total + jnp.where(active, 1, 0)

            small_dj = dJ < opts.cost_tolerance
            converged = small_dj & (grad < opts.gradient_tolerance)
            # numerical-floor stall exit (SolverOptions.max_stall_iterations):
            # its own status so it can't masquerade as SOLVED
            stall = jnp.where(active & small_dj, c["stall"] + 1,
                              jnp.where(active, 0, c["stall"]))
            if opts.max_stall_iterations > 0:
                stalled = (stall >= opts.max_stall_iterations) & ~converged
            else:
                stalled = jnp.zeros_like(converged)
            hit_inner = inner >= opts.max_iterations_inner
            hit_total = total >= max_total
            bad = status != jnp.int32(SolverStatus.UNSOLVED)
            status = jnp.where(
                converged,
                jnp.int32(SolverStatus.SOLVED),
                jnp.where(
                    stalled,
                    jnp.int32(SolverStatus.SOLVED_STALLED),
                    jnp.where(
                        hit_inner,
                        jnp.int32(SolverStatus.MAX_INNER_ITERATIONS),
                        jnp.where(
                            hit_total, jnp.int32(SolverStatus.MAX_ITERATIONS), status
                        ),
                    ),
                ),
            )
            done_new = converged | stalled | hit_inner | hit_total | bad

            stats = stats.replace(
                iterations_inner=jnp.where(active, inner, stats.iterations_inner),
                iterations_total=jnp.where(active, total, stats.iterations_total),
                cost=jnp.where(active, cost_new, stats.cost),
                cost_decrease=jnp.where(active, dJ, stats.cost_decrease),
                gradient=jnp.where(active, grad, stats.gradient),
                alpha=jnp.where(active & fp["success"], fp["alpha"], stats.alpha),
                improvement_ratio=jnp.where(
                    active & fp["success"], fp["z"], stats.improvement_ratio
                ),
                regularization=jnp.where(active, bp["rho"], stats.regularization),
            )
            stats = _record_history(stats, active)
            self._emit_inner_row(active, stats)
            out = dict(
                Z=zselect(active, fp["Z"], c["Z"]),
                rho=jnp.where(active, fp["rho"], c["rho"]),
                drho=jnp.where(active, fp["drho"], c["drho"]),
                stats=stats,
                cost_last=jnp.where(active, cost_new, c["cost_last"]),
                status=jnp.where(active, status, c["status"]),
                done=c["done"] | (active & done_new),
                stall=stall,
                K=btree_select(active, bp["K"], c["K"]),
                d=btree_select(active, bp["d"], c["d"]),
            )
            return out

        init = dict(
            Z=Z,
            rho=jnp.full((Bsz,), opts.bp_reg_initial, dt),
            drho=jnp.zeros((Bsz,), dt),
            stats=stats,
            cost_last=J_init,
            status=jnp.full((Bsz,), SolverStatus.UNSOLVED, jnp.int32),
            done=~outer_active,
            stall=jnp.zeros((Bsz,), jnp.int32),
            K=jnp.zeros((N, m, n, Bsz), dt),
            d=jnp.zeros((N, m, Bsz), dt),
        )
        out = jax.lax.while_loop(cond, body, init)
        return out

    # ------------------------------------------------------------- AL outer
    def al_state_init(self, Bsz: int, dtype) -> tuple:
        out = []
        for fam in self.prob.constraint_families:
            nk = len(fam.knots)
            out.append(
                dict(
                    lam=jnp.zeros((nk, fam.dim, Bsz), dtype),
                    rho=jnp.full((nk, Bsz), self.opts.initial_penalty, dtype),
                )
            )
        return tuple(out)

    def constraint_values(self, params, Z):
        return tuple(
            self._con_values(fam, fp, cp, *self._family_xu(fam, Z))
            for fam, fp, cp in zip(
                self.prob.constraint_families,
                params.constraints,
                self.prob.params.constraints,
            )
        )

    def _outer_duals_and_violation(self, params, Z, al, upd):
        """Dual update λ ← Π_{K*}(λ−ρc) + max-violation measure for the
        outer loop.  Runs in f64 when `opts.outer_constraints_f64` (see
        the option's rationale: the f32 error in c is ρ-amplified exactly
        here); everything f64 happens inside one enable_x64 block and only
        f32 results leave it.  Returns (al_new tuple, viol [B] f32)."""
        dt = Z.X.dtype
        Bsz = Z.X.shape[-1]
        use64 = self.opts.outer_constraints_f64 and dt == jnp.float32

        def compute(params_c, Z_c, cdt):
            cvals = self.constraint_values(params_c, Z_c)
            al_new = []
            for fam, st, cv in zip(self.prob.constraint_families, al, cvals):
                dual = dual_cone(fam.cone)
                s = st["lam"].astype(cdt) - st["rho"].astype(cdt)[
                    :, None, :
                ] * cv
                if dual is Cone.IDENTITY:
                    lam = s
                elif dual is Cone.ZERO:
                    lam = jnp.zeros_like(s)
                elif dual is Cone.SECOND_ORDER:
                    lam = soc_project_bl(s)
                else:
                    lam = jnp.minimum(s, 0.0)
                lam = bwhere(upd, lam.astype(dt), st["lam"])
                al_new.append(dict(lam=lam, rho=st["rho"]))
            viol = self.max_violation(cvals, Bsz, cdt).astype(dt)
            return tuple(al_new), viol

        if not use64:
            return compute(params, Z, dt)
        with jax.enable_x64():
            f64 = jnp.float64

            def cast(leaf):
                leaf = jnp.asarray(leaf)
                if jnp.issubdtype(leaf.dtype, jnp.floating):
                    return leaf.astype(f64)
                return leaf

            Z64 = dataclasses.replace(
                Z, X=Z.X.astype(f64), U=Z.U.astype(f64),
                t=Z.t.astype(f64), h=Z.h.astype(f64),
            )
            params64 = jax.tree_util.tree_map(cast, params)
            return compute(params64, Z64, f64)

    def max_violation(self, cvals, Bsz, dtype):
        viol = jnp.zeros((Bsz,), dtype)
        for fam, c in zip(self.prob.constraint_families, cvals):
            if fam.cone is Cone.ZERO:
                v = jnp.abs(c)
            elif fam.cone is Cone.NEGATIVE_ORTHANT:
                v = jnp.maximum(c, 0.0)
            elif fam.cone is Cone.SECOND_ORDER:
                v = jnp.abs(c - soc_project_bl(c))
            else:  # IDENTITY: whole space, never violated
                continue
            viol = jnp.maximum(viol, v.max(axis=(0, 1)))
        return viol

    def solve(
        self,
        params: ProblemParams,
        Z: BatchedTrajectory,
        al=None,
        active=None,
        lane_opts=None,
    ):
        """Full batched AL solve.  Returns dict with batch-last results.

        `active` [B] (optional) gates instances: inactive lanes are never
        iterated (the solve is free when none are active) and their
        outputs are the inputs passed through — used by the device-side
        compaction tail (`solver/compaction.py`) where padding lanes hold
        already-finished instances.

        `lane_opts` (optional dict of [B] arrays) overrides selected
        solver options PER LANE: `penalty_scaling`,
        `max_iterations_outer`, `max_iterations_total`.  This is what
        lets a restart portfolio (`solver/compaction.py`) run several
        penalty-ladder variants of the same instances side by side in one
        widened batch instead of sequential rounds.
        """
        opts = self.opts
        lane_opts = lane_opts or {}
        ps_lane = lane_opts.get("penalty_scaling", opts.penalty_scaling)
        max_outer = lane_opts.get(
            "max_iterations_outer", opts.max_iterations_outer
        )
        max_total_l = lane_opts.get(
            "max_iterations_total", opts.max_iterations_total
        )
        dt = Z.X.dtype
        Bsz = Z.X.shape[-1]
        N, n, m = self.prob.N, self.prob.n, self.prob.m
        if active is None:
            active0 = jnp.ones((Bsz,), bool)
        else:
            active0 = jnp.asarray(active, bool)

        if al is None:
            al = self.al_state_init(Bsz, dt)
        else:
            if opts.reset_duals:
                al = tuple(
                    dict(lam=jnp.zeros_like(s["lam"]), rho=s["rho"]) for s in al
                )
            if opts.initial_penalty > 0:
                al = tuple(
                    dict(lam=s["lam"], rho=jnp.full_like(s["rho"], opts.initial_penalty))
                    for s in al
                )
        stats = batched_stats_init(Bsz, dt, opts.iteration_history_capacity)
        if opts.iteration_history_capacity > 0 and self.prob.constraint_families:
            # seed the viol/pen columns like the per-instance solver's
            # pre-solve log (`solver/al.py`: stats_log before the loop)
            cvals0 = self.constraint_values(params, Z)
            pen0 = jnp.zeros((Bsz,), dt)
            for st in al:
                pen0 = jnp.maximum(pen0, st["rho"].max(axis=0))
            stats = stats.replace(
                violations=self.max_violation(cvals0, Bsz, dt),
                max_penalty=pen0,
            )

        if not self.prob.constraint_families:
            out = self.ilqr_solve(params, al, Z, stats, active0, lane_opts)
            return dict(
                Z=out["Z"], al=al, status=out["status"], stats=out["stats"],
                K=out["K"], d=out["d"],
            )

        def cond(c):
            return jnp.any(~c["done"])

        def body(c):
            active = ~c["done"]
            res = self.ilqr_solve(
                params, c["al"], c["Z"], c["stats"], active, lane_opts
            )
            Z2 = res["Z"]
            stats: BatchedStats = res["stats"]
            inner_solved = res["status"] == jnp.int32(SolverStatus.SOLVED)
            # a stall-exited inner solve continues the outer loop (see
            # solver/al.py) but taints the final status to SOLVED_STALLED
            inner_ok = inner_solved | (
                res["status"] == jnp.int32(SolverStatus.SOLVED_STALLED)
            )
            upd = active if opts.update_duals_on_failed_inner else (
                active & inner_ok
            )
            al_new, viol = self._outer_duals_and_violation(
                params, Z2, c["al"], upd
            )
            pen = jnp.zeros((Bsz,), dt)
            for st in al_new:
                pen = jnp.maximum(pen, st["rho"].max(axis=0))
            outer = stats.iterations_outer + jnp.where(active, 1, 0)
            stats = stats.replace(
                iterations_outer=jnp.where(active, outer, stats.iterations_outer),
                violations=jnp.where(active, viol, stats.violations),
                max_penalty=jnp.where(active, pen, stats.max_penalty),
            )

            sat = viol < opts.constraint_tolerance
            pen_hi = pen > opts.maximum_penalty
            outer_hi = outer >= max_outer
            total_hi = stats.iterations_total >= max_total_l
            # stalled_feasible_exits=False: a feasible-but-stalled instance
            # keeps escalating the penalty until its inner solve genuinely
            # converges (see SolverOptions)
            sat_done = sat if opts.stalled_feasible_exits else (
                sat & inner_solved
            )
            status = jnp.where(
                ~inner_ok,
                res["status"],
                jnp.where(
                    sat_done,
                    jnp.where(
                        inner_solved,
                        jnp.int32(SolverStatus.SOLVED),
                        jnp.int32(SolverStatus.SOLVED_STALLED),
                    ),
                    jnp.where(
                        pen_hi,
                        jnp.int32(SolverStatus.MAX_PENALTY),
                        jnp.where(
                            outer_hi,
                            jnp.int32(SolverStatus.MAX_OUTER_ITERATIONS),
                            jnp.where(
                                total_hi,
                                jnp.int32(SolverStatus.MAX_ITERATIONS),
                                jnp.int32(SolverStatus.UNSOLVED),
                            ),
                        ),
                    ),
                ),
            )
            if not opts.stalled_feasible_exits:
                # a cap ending a continuing feasible-stalled instance keeps
                # the SOLVED_STALLED label (never worse than exiting early)
                capped = pen_hi | outer_hi | total_hi
                status = jnp.where(
                    inner_ok & sat & ~sat_done & capped,
                    jnp.int32(SolverStatus.SOLVED_STALLED),
                    status,
                )
            done_new = (~inner_ok) | sat_done | pen_hi | outer_hi | total_hi
            self._emit_outer_row(
                active & ~done_new, jnp.where(active, status, c["status"]), stats
            )
            # scale penalties only for continuing instances
            cont = active & ~done_new
            al_next = tuple(
                dict(
                    lam=st["lam"],
                    rho=bwhere(cont, st["rho"] * ps_lane, st["rho"]),
                )
                for st in al_new
            )
            return dict(
                Z=zselect(active, Z2, c["Z"]),
                al=btree_select(active, al_next, c["al"]),
                stats=stats,
                status=jnp.where(active, status, c["status"]),
                done=c["done"] | (active & done_new),
                K=btree_select(active, res["K"], c["K"]),
                d=btree_select(active, res["d"], c["d"]),
            )

        init = dict(
            Z=Z,
            al=al,
            stats=stats,
            status=jnp.full((Bsz,), SolverStatus.UNSOLVED, jnp.int32),
            done=~active0,
            K=jnp.zeros((N, m, n, Bsz), dt),
            d=jnp.zeros((N, m, Bsz), dt),
        )
        out = jax.lax.while_loop(cond, body, init)
        return dict(
            Z=out["Z"], al=out["al"], status=out["status"], stats=out["stats"],
            K=out["K"], d=out["d"],
        )


def _increase_reg(rho, drho, opts: SolverOptions):
    drho = jnp.maximum(drho * opts.bp_reg_increase_factor, opts.bp_reg_increase_factor)
    rho = jnp.clip(rho * drho, opts.bp_reg_min, opts.bp_reg_max)
    return rho, drho


def _decrease_reg(rho, drho, opts: SolverOptions):
    drho = jnp.minimum(
        drho / opts.bp_reg_increase_factor, 1.0 / opts.bp_reg_increase_factor
    )
    rho = jnp.clip(rho * drho, opts.bp_reg_min, opts.bp_reg_max)
    return rho, drho
