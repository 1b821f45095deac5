"""Fused backward-pass kernel (Pallas through Triton): expansions + Riccati.

Without it, `ALSolverBatched.expand` materializes the per-knot expansions
(`lx, lu, lxx, lxu, luu, A, B`: ≈65 MB at B=4096, N=100, f32) to device
memory and `riccati_scan` immediately streams them back in, one small
launch per knot.  The reference's own profile shows the same split:
expansions are 31-35% of its solve.

This kernel computes the expansions ON THE FLY inside the backward sweep.
Like `ForwardKernel` it holds one solve per lane with the time loop inside
the kernel: at knot k it reads only (x_k, u_k, λ_k, ρ_k), rebuilds the
quadratic-cost expansion from the cost params, assembles the AL
Gauss-Newton terms from the structured constraints
(`constraint_values.hpp:131-177` algebra, diagonal cones), differentiates
the RK4/Euler step with the per-lane Jacobian of the continuous dynamics
(`integration.hpp:132-169` chain rule), and runs the Riccati recursion with
the cost-to-go carry (P, p, ΔV, failed) in loop-carried registers
(`ilqr.hpp:385-445`).  It also Kahan-accumulates the trajectory's AL cost,
so the caller gets J0 for free and the separate cost pass disappears.

Eligibility matches `ForwardKernel`; the solver falls back to `expand` +
`riccati_scan` otherwise.  Semantics equal `expand` + `riccati_scan`
(tests/test_backward_fused.py in interpret mode; compiled on the GPU by
`perf/verify_kernels.py` and tests/test_gpu_compiled.py).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import pallas as pl

from ..problem.constraints import Cone
from . import lanes
from .forward_pallas import ForwardKernel, Ineligible, _kadd


# ------------------------------------------------- LaneArray linear algebra
def _ew(op, *arrs):
    """Elementwise `op` over broadcast LaneArrays."""
    arrs = np.broadcast_arrays(*arrs)
    out = np.empty(arrs[0].shape, object)
    for idx in np.ndindex(out.shape):
        out[idx] = op(*(a[idx] for a in arrs))
    return out


def _scale(s, a):
    return _ew(lambda e: lanes.mul(s, e), a)


def _add(a, b):
    return _ew(lanes.add, a, b)


def _mm(a, b):
    """[i,j] @ [j,k] of LaneArrays, unrolled (structural zeros fold)."""
    out = np.empty((a.shape[0], b.shape[1]), object)
    for i in range(a.shape[0]):
        for k in range(b.shape[1]):
            acc = lanes.mul(a[i, 0], b[0, k])
            for j in range(1, a.shape[1]):
                acc = lanes.add(acc, lanes.mul(a[i, j], b[j, k]))
            out[i, k] = acc
    return out


def _mv(a, v):
    return _mm(a, v[:, None])[:, 0]


def _chol(M, diag_add):
    """Unrolled Cholesky of an m×m LaneArray of vectors (+ diag_add on the
    diagonal); returns (L as nested lists, failed)."""
    m = M.shape[0]
    L = [[None] * m for _ in range(m)]
    failed = None
    for j in range(m):
        s = M[j, j] + diag_add
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        # NaN-safe: NaN > 0 is False, so non-finite pivots flag failure too
        bad = jnp.logical_not(s > 0.0)
        failed = bad if failed is None else failed | bad
        dj = jnp.sqrt(jnp.maximum(s, 1e-30))
        L[j][j] = dj
        inv = 1.0 / dj
        for i in range(j + 1, m):
            s = M[i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv
    return L, failed


def _chol_solve(L, R):
    """(L Lᵀ) X = R with R an [m, r] LaneArray of vectors."""
    m, r = R.shape
    X = np.empty((m, r), object)
    for c in range(r):
        y = [None] * m
        for i in range(m):
            acc = R[i, c]
            for k in range(i):
                acc = acc - L[i][k] * y[k]
            y[i] = acc / L[i][i]
        x = [None] * m
        for i in reversed(range(m)):
            acc = y[i]
            for k in range(i + 1, m):
                acc = acc - L[k][i] * x[k]
            x[i] = acc / L[i][i]
        X[:, c] = lanes.lane_array(x)
    return X


class BackwardFusedKernel(ForwardKernel):
    """Fused expansion + Riccati backward kernel for one problem.

    `__call__(params, al_pad, Z, rho)` returns
    `(K [N,m,n,B], d [N,m,B], dV1 [B], dV2 [B], failed [B], J0 [B])` equal to
    `expand` + `riccati_scan` (+ per-knot cost sum) to rounding.
    """

    # Timed 32/64/128 lanes per program on the parking fleet at B=4096 on
    # an H100 at 400 W: 0.61 / 0.47 / 0.52 ms per call; 64/128 on one at
    # 700 W: 0.42 / 0.38 ms at B=4096, 0.47 / 0.48 ms at B=4000 (PERF.md).
    gpu_block = 64

    _traj_inputs = ("X", "U", "rho_reg")

    # Largest state dimension the kernel accepts.  Each lane unrolls the
    # RK4 Jacobian chain rule and the Riccati products, ~n³ scalar ops per
    # knot, and Triton's compile time grows with them.  Compile times on the
    # H100 (`perf/backward_compile_limit.py`): parking n=3 1.9 s, cartpole
    # n=4 3.7 s, triple integrator n=6 10.3 s and n=9 71.5 s (linear
    # dynamics, mostly structural zeros); the quadrotor (n=13) had not
    # compiled after 10 minutes.  Wider states run `expand` +
    # `riccati_scan`.
    max_state_dim = 6

    def _probe_dynamics(self):
        if self.n > self.max_state_dim:
            raise Ineligible(
                f"state dimension {self.n} > {self.max_state_dim} for the "
                f"fused backward kernel"
            )
        super()._probe_dynamics()
        n, m, dt = self.n, self.m, self.dtype
        try:
            lanes.probe(
                lambda p, x, u, t: jax.jacfwd(self._cont_fn, argnums=(1, 2))(
                    p, x, u, t
                ),
                self._dyn_param_structs(),
                jax.ShapeDtypeStruct((n,), dt),
                jax.ShapeDtypeStruct((m,), dt),
                jax.ShapeDtypeStruct((), dt),
            )
        except NotImplementedError as e:
            raise Ineligible(f"dynamics Jacobian has no per-lane form: {e}")

    # ------------------------------------------------------- lane expansions
    def _lane_quad_expansion(self, get, sig, f, x, u, row):
        """Quadratic-cost expansion per lane: value J, gradient rows
        (lx [n], lu [m]) and the constant Hessian entries as accessors
        (Qv/Hv/Rv) for direct accumulation (`quadratic_cost.cpp:8-63`)."""
        n, m = self.n, self.m
        Qv_, Rv_, Hv_, qv_, rv_, _ = self._quad_readers(get, sig, f)
        Qv = lambda i, j: Qv_(row, i, j)
        Rv = lambda i, j: Rv_(row, i, j)
        Hv = lambda i, j: Hv_(row, i, j)
        qv = lambda i: qv_(row, i)
        rv = lambda i: rv_(row, i)
        J = self._lane_quad(get, sig, f, x, u, row)
        lx = []
        for i in range(n):
            acc = qv(i) + Qv(i, i) * x[i]
            for j in range(n):
                if j != i:
                    acc += Qv(min(i, j), max(i, j)) * x[j]
            if u is not None:
                for j in range(m):
                    acc += Hv(i, j) * u[j]
            lx.append(acc)
        lu = None
        if u is not None:
            lu = []
            for i in range(m):
                acc = rv(i) + Rv(i, i) * u[i]
                for j in range(m):
                    if j != i:
                        acc += Rv(min(i, j), max(i, j)) * u[j]
                for j in range(n):
                    acc += Hv(j, i) * x[j]
                lu.append(acc)
        return J, lx, lu, Qv, Hv, Rv

    def _lane_al_expansion(self, get, sig, f, x, u, lam_rows, rho):
        """AL value + gradient/Gauss-Newton contributions for one structured
        constraint family per lane (`constraint_values.hpp:111-177`).

        Returns (J, gx [n], gu [m], Hxx [n][n], Hxu [n][m], Huu [m][m]) as
        accumulation lists.
        """
        n, m = self.n, self.m
        c_rows = self._lane_con_rows(get, sig, f, x, u)
        J = self._al_value(f["cone"], lam_rows, rho, c_rows)
        zero = jnp.zeros_like(x[0])
        gx = [zero] * n
        gu = [zero] * m
        Hxx = [[zero] * n for _ in range(n)]
        Hxu = [[zero] * m for _ in range(n)]
        Huu = [[zero] * m for _ in range(m)]
        kind = f["structure"][0]
        for r, (lam, c) in enumerate(zip(lam_rows, c_rows)):
            s = lam - rho * c
            if f["cone"] is Cone.ZERO:  # dual IDENTITY: Π = id
                proj = s
                dp = jnp.ones_like(s)
            else:  # NEGATIVE_ORTHANT is self-dual
                proj = jnp.minimum(s, 0.0)
                dp = jnp.where(s <= 0.0, 1.0, 0.0).astype(s.dtype)
            # gradient = -Σ_r dp_r · C[r,:] · proj_r; Hessian (GN) =
            # ρ Σ_r dp_r · C[r,:]ᵀC[r,:] (dp² = dp for 0/1 masks)
            w = dp * proj
            hw = rho * dp
            if kind == "goal":
                gx[r] = gx[r] - w
                Hxx[r][r] = Hxx[r][r] + hw
            elif kind == "control_bound":
                _, lo_idx, hi_idx = f["structure"]
                if r < len(lo_idx):  # c = lb - u_j, C_u[r, j] = -1
                    j = lo_idx[r]
                    gu[j] = gu[j] + w
                    Huu[j][j] = Huu[j][j] + hw
                else:  # c = u_j - ub, C_u[r, j] = +1
                    j = hi_idx[r - len(lo_idx)]
                    gu[j] = gu[j] - w
                    Huu[j][j] = Huu[j][j] + hw
            else:  # circle: c = r² - dx² - dy²; C_x = (-2dx, -2dy)
                _, xi, yi = f["structure"]
                cx = self._pacc(get, sig, f"con{f['fi']}_cx")
                cy = self._pacc(get, sig, f"con{f['fi']}_cy")
                dx = x[xi] - cx(r)
                dy = x[yi] - cy(r)
                gx[xi] = gx[xi] + 2.0 * dx * w
                gx[yi] = gx[yi] + 2.0 * dy * w
                Hxx[xi][xi] = Hxx[xi][xi] + 4.0 * hw * dx * dx
                Hxx[yi][yi] = Hxx[yi][yi] + 4.0 * hw * dy * dy
                hxy = 4.0 * hw * dx * dy
                lo, hi = min(xi, yi), max(xi, yi)
                Hxx[lo][hi] = Hxx[lo][hi] + hxy
                Hxx[hi][lo] = Hxx[hi][lo] + hxy
        return J, gx, gu, Hxx, Hxu, Huu

    def _lane_dyn_jacobian(self, dyn_params, x, u, t, h):
        """Discrete A [n,n], B [n,m] LaneArrays of the rk4/euler step — the
        hand chain rule of `integration.hpp:132-169` over per-lane
        Jacobians of the continuous fn.  Structural zeros of the Jacobians
        stay NumPy constants and fold out of the products."""
        n = self.n
        width = x[0].shape[0]
        dt = self.dtype
        ul = lanes.lane_array(list(u))
        # one vector each, not a broadcast at every use
        h = lanes.vec(h, width, dt)
        t = lanes.vec(t, width, dt)

        def cont_jac(xs, tt):
            return lanes.call(
                lambda p, xx, uu, t_: jax.jacfwd(self._cont_fn, argnums=(1, 2))(
                    p, xx, uu, t_
                ),
                dyn_params,
                lanes.lane_array(list(xs)),
                ul,
                lanes.lane_array(tt, shape=()),
            )

        eye = lanes.const_array(np.eye(n), dt)
        if self._method == "euler":
            Ac, Bc = cont_jac(x, t)
            return _add(eye, _scale(h, Ac)), _scale(h, Bc)

        def f(xs, tt):
            return [lanes.vec(e, width, dt) for e in self._cont(dyn_params, xs, u, tt)]

        k1 = f(x, t)
        x2 = [x[i] + 0.5 * h * k1[i] for i in range(n)]
        k2 = f(x2, t + 0.5 * h)
        x3 = [x[i] + 0.5 * h * k2[i] for i in range(n)]
        k3 = f(x3, t + 0.5 * h)
        x4 = [x[i] + h * k3[i] for i in range(n)]
        A1, B1 = cont_jac(x, t)
        A2, B2 = cont_jac(x2, t + 0.5 * h)
        A3, B3 = cont_jac(x3, t + 0.5 * h)
        A4, B4 = cont_jac(x4, t + h)
        half_h = 0.5 * h
        half = np.asarray(0.5, dt)
        dA1 = _scale(h, A1)
        dA2 = _scale(h, _mm(A2, _add(eye, _scale(half, dA1))))
        dA3 = _scale(h, _mm(A3, _add(eye, _scale(half, dA2))))
        dA4 = _scale(h, _mm(A4, _add(eye, dA3)))
        sixth = np.asarray(1.0 / 6.0, dt)
        two = np.asarray(2.0, dt)

        def rk4_sum(e1, e2, e3, e4):  # (e1 + 2 e2 + 2 e3 + e4) / 6
            acc = lanes.add(e1, lanes.mul(two, e2))
            acc = lanes.add(acc, lanes.mul(two, e3))
            return lanes.mul(lanes.add(acc, e4), sixth)

        A = _add(eye, _ew(rk4_sum, dA1, dA2, dA3, dA4))
        dB1 = _scale(h, B1)
        dB2 = _add(_scale(h, B2), _scale(half_h, _mm(A2, dB1)))
        dB3 = _add(_scale(h, B3), _scale(half_h, _mm(A3, dB2)))
        dB4 = _add(_scale(h, B4), _scale(h, _mm(A4, dB3)))
        return A, _ew(rk4_sum, dB1, dB2, dB3, dB4)

    # --------------------------------------------------------------- kernel
    def _stage_expansion(self, get, sig, k, x, u, J, comp):
        """Cost + AL expansion at stage knot k; returns
        (J, comp, lx [n], lu [m], lxx, lxu, luu as LaneArrays)."""
        n, m, N = self.n, self.m, self.N
        zero = jnp.zeros_like(x[0])
        lx = [zero] * n
        lu = [zero] * m
        lxx = [[zero] * n for _ in range(n)]
        lxu = [[zero] * m for _ in range(n)]
        luu = [[zero] * m for _ in range(m)]
        for f in self._cost_fams:
            if f["k0"] > N - 1:
                continue
            nk = f["k1"] - f["k0"] + 1
            row = jnp.clip(k - f["k0"], 0, nk - 1)
            Jq, glx, glu, Qv, Hv, Rv = self._lane_quad_expansion(
                get, sig, f, x, u, row
            )
            gate = lambda v, f=f: self._gate(f, k, v)
            J, comp = _kadd(J, comp, gate(Jq))
            for i in range(n):
                lx[i] = lx[i] + gate(glx[i])
                for j in range(n):
                    lxx[i][j] = lxx[i][j] + gate(Qv(min(i, j), max(i, j)) + zero)
                for j in range(m):
                    lxu[i][j] = lxu[i][j] + gate(Hv(i, j) + zero)
            for i in range(m):
                lu[i] = lu[i] + gate(glu[i])
                for j in range(m):
                    luu[i][j] = luu[i][j] + gate(Rv(min(i, j), max(i, j)) + zero)
        for f in self._con_fams:
            if not f["stage"]:
                continue
            fi = f["fi"]
            lam_rows = [get(f"lam{fi}")[k, r, :] for r in range(f["p"])]
            rho_c = get(f"rho{fi}")[k, :]
            Jc, gx, gu, Hxx, Hxu, Huu = self._lane_al_expansion(
                get, sig, f, x, u, lam_rows, rho_c
            )
            gate = lambda v, f=f: self._gate(f, k, v)
            J, comp = _kadd(J, comp, gate(Jc))
            for i in range(n):
                lx[i] = lx[i] + gate(gx[i])
                for j in range(n):
                    lxx[i][j] = lxx[i][j] + gate(Hxx[i][j])
                for j in range(m):
                    lxu[i][j] = lxu[i][j] + gate(Hxu[i][j])
            for i in range(m):
                lu[i] = lu[i] + gate(gu[i])
                for j in range(m):
                    luu[i][j] = luu[i][j] + gate(Huu[i][j])
        la = lanes.lane_array
        return J, comp, la(lx), la(lu), la(lxx), la(lxu), la(luu)

    def _terminal_expansion(self, get, sig, xs):
        """Terminal cost-to-go (P_N, p_N) and terminal cost (J, comp)."""
        n, m, N = self.n, self.m, self.N
        zero = jnp.zeros_like(xs[0])
        J, comp = zero, zero
        lxT = [zero] * n
        lxxT = [[zero] * n for _ in range(n)]
        for f in self._cost_fams:
            if f["k1"] != N:
                continue
            Jq, lx, _, Qv, _, _ = self._lane_quad_expansion(
                get, sig, f, xs, None, N - f["k0"]
            )
            J, comp = _kadd(J, comp, Jq)
            for i in range(n):
                lxT[i] = lxT[i] + lx[i]
                for j in range(n):
                    lxxT[i][j] = lxxT[i][j] + Qv(min(i, j), max(i, j)) + zero
        for f in self._con_fams:
            if not f["terminal"]:
                continue
            fi = f["fi"]
            lam_rows = [get(f"lamT{fi}")[r, :] for r in range(f["p"])]
            rho_c = get(f"rhoT{fi}")[:]
            um = [zero] * m if f["structure"][0] == "control_bound" else None
            Jc, gx, _, Hxx, _, _ = self._lane_al_expansion(
                get, sig, f, xs, um, lam_rows, rho_c
            )
            J, comp = _kadd(J, comp, Jc)
            for i in range(n):
                lxT[i] = lxT[i] + gx[i]
                for j in range(n):
                    lxxT[i][j] = lxxT[i][j] + Hxx[i][j]
        return lxxT, lxT, J, comp

    def _make_kernel(self, sig: frozenset, names, block):
        n, m, N = self.n, self.m, self.N
        dt = self.dtype
        glim = float(self.opts.bp_gain_limit)
        n_in = len(names)

        def kernel(*refs):
            in_refs = refs[:n_in]
            K_ref, d_ref, dV1_ref, dV2_ref, failed_ref, J0_ref = refs[n_in:]

            def get(name):
                return in_refs[names[name]]

            th = get("th")
            dyn_params = self._dyn_params_in_kernel(get, sig, block)
            rho = get("rho_reg")[:]
            X, U = get("X"), get("U")
            vec = lambda e: lanes.vec(e, block, dt)

            def body(i, carry):
                P, p, dv1, dv2, failed, J, comp = carry
                P = lanes.lane_array(list(P)).reshape(n, n)
                p = lanes.lane_array(list(p))
                k = N - 1 - i
                x = [X[k, r, :] for r in range(n)]
                u = [U[k, r, :] for r in range(m)]
                J, comp, lx, lu, lxx, lxu, luu = self._stage_expansion(
                    get, sig, k, x, u, J, comp
                )
                A, Bd = self._lane_dyn_jacobian(
                    dyn_params, x, u, th[k, 0], th[k, 1]
                )

                # Riccati step (`ilqr.hpp:385-445`)
                AtP = _mm(A.T, P)
                Qxx = _ew(vec, _add(lxx, _mm(AtP, A)))
                Qxu = _ew(vec, _add(lxu, _mm(AtP, Bd)))
                Quu = _ew(vec, _add(luu, _mm(Bd.T, _mm(P, Bd))))
                Qx = _ew(vec, _add(lx, _mv(A.T, p)))
                Qu = _ew(vec, _add(lu, _mv(Bd.T, p)))

                L, fail_k = _chol(Quu, rho)
                K = _ew(lambda e: -e, _chol_solve(L, Qxu.T))
                d = _ew(lambda e: -e, _chol_solve(L, Qu[:, None])[:, 0])
                # gain-magnitude guard (SolverOptions.bp_gain_limit)
                gmax = jnp.abs(K[0, 0])
                for e in list(K.flat)[1:] + list(d):
                    gmax = jnp.maximum(gmax, jnp.abs(e))
                fail_k = fail_k | jnp.logical_not(gmax <= glim)

                KtQuu = _mm(K.T, Quu)
                p_new = _add(_add(_add(Qx, _mv(KtQuu, d)), _mv(K.T, Qu)), _mv(Qxu, d))
                # KᵀQxuᵀ = (QxuK)ᵀ with identical per-term products and
                # summation order — reuse the transpose
                QK = _mm(Qxu, K)
                P_new = _add(_add(_add(Qxx, _mm(KtQuu, K)), QK.T), QK)
                Qd = _mv(Quu, d)
                dV1_new = d[0] * Qu[0]
                dV2_new = d[0] * Qd[0]
                for r in range(1, m):
                    dV1_new = dV1_new + d[r] * Qu[r]
                    dV2_new = dV2_new + d[r] * Qd[r]
                dV2_new = 0.5 * dV2_new

                now_failed = failed | fail_k
                keep = jnp.logical_not(now_failed)
                P = tuple(jnp.where(keep, a, b) for a, b in zip(P_new.flat, P.flat))
                p = tuple(jnp.where(keep, a, b) for a, b in zip(p_new, p))
                dv1 = jnp.where(keep, dv1 + dV1_new, dv1)
                dv2 = jnp.where(keep, dv2 + dV2_new, dv2)
                for r in range(m):
                    d_ref[k, r, :] = d[r]
                    for c in range(n):
                        K_ref[k, r, c, :] = K[r, c]
                return P, p, dv1, dv2, now_failed, J, comp

            xN = [X[N, r, :] for r in range(n)]
            PN, pN, J, comp = self._terminal_expansion(get, sig, xN)
            zero = jnp.zeros((block,), dt)
            init = (
                tuple(vec(e) for row in PN for e in row),
                tuple(vec(e) for e in pN),
                zero,
                zero,
                jnp.zeros((block,), jnp.bool_),
                vec(J),
                vec(comp),
            )
            _, _, dv1, dv2, failed, J, comp = lax.fori_loop(0, N, body, init)
            dV1_ref[:] = dv1
            dV2_ref[:] = dv2
            failed_ref[:] = failed.astype(jnp.int32)
            J0_ref[:] = J - comp

        return kernel

    def _get_call(self, B: int, sig: frozenset, arrays):
        key = (B, sig)
        if key not in self._kernels:
            n, m, N = self.n, self.m, self.N
            block = self.block_for(B)
            names, lane_mask = self._input_layout(sig)
            lane_out = lambda *dims: pl.BlockSpec(
                dims + (block,), lambda b, nd=len(dims): (0,) * nd + (b,)
            )
            self._kernels[key] = self._pallas_call(
                self._make_kernel(sig, names, block),
                in_specs=self._specs(arrays, lane_mask, block),
                out_specs=[lane_out(N, m, n), lane_out(N, m)]
                + [lane_out() for _ in range(4)],
                out_shape=[
                    jax.ShapeDtypeStruct((N, m, n, B), self.dtype),
                    jax.ShapeDtypeStruct((N, m, B), self.dtype),
                    jax.ShapeDtypeStruct((B,), self.dtype),
                    jax.ShapeDtypeStruct((B,), self.dtype),
                    jax.ShapeDtypeStruct((B,), jnp.int32),
                    jax.ShapeDtypeStruct((B,), self.dtype),
                ],
                grid=(B // block,),
                block=block,
                name="altro_backward",
            )
        return self._kernels[key]

    # ----------------------------------------------------------------- call
    def __call__(self, params, al_pad, Z, rho):
        B = Z.X.shape[-1]
        dt = self.dtype
        sig = self.param_sig(params)
        arrays = [self._th(Z)]
        arrays += self._param_arrays(params, sig)
        arrays += [jnp.asarray(Z.X, dt), jnp.asarray(Z.U, dt)]
        arrays.append(jnp.broadcast_to(jnp.asarray(rho, dt), (B,)))
        arrays += self._al_arrays(al_pad)
        arrays, Bp = self._pad_lanes(arrays, sig, B)
        call = self._get_call(Bp, sig, arrays)
        K, d, dV1, dV2, failed, J0 = (o[..., :B] for o in call(*arrays))
        return K, d, dV1, dV2, failed > 0, J0


def build_backward_fused_kernel(
    prob, opts, *, interpret: bool = False, dtype=jnp.float32
):
    """Build the fused kernel, or return None if the problem is ineligible."""
    try:
        return BackwardFusedKernel(prob, opts, interpret=interpret, dtype=dtype)
    except Ineligible:
        return None
