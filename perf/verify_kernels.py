"""Compiled Pallas kernels vs the XLA scan oracles, on the device.

The CPU test suite checks both kernels in interpret mode, in f64, where
agreement with the oracles is algorithmic.  This module checks the
COMPILED kernels — the code path behind every timed solve — against the
oracles on the live GPU, in f32.  `chip_smoke.py` runs it before it times
anything, and tests/test_gpu_compiled.py wraps it as card-only tests.

Bounds, f32 with matmul precision "highest" (the kernels and the oracles
sum in different orders and XLA may contract multiply-adds differently, so
they agree to f32 round-off of a long recursion, not bit for bit):
  * K, d: 3e-4 relative to max(|oracle|, 1) — the Riccati carry gathers
    ~1e-6 relative noise per knot; 3e-4 leaves a wide margin over N=100
    knots without admitting a wrong sign or index;
  * dV1 and J0: 1e-5 relative — sums of well-scaled terms;
  * forward X, U: 1e-4 absolute, J 1e-4 relative — the rollout runs the
    oracle's gains, so the only difference is rounding in the dynamics;
  * failed, valid and status equal exactly.
"""
from __future__ import annotations

import numpy as np

TRITON_CALL = "__gpu$xla.gpu.triton"

BOUNDS = dict(
    K_rel=3e-4, d_rel=3e-4, dV1_rel=1e-5, J0_rel=1e-5,
    fwd_X=1e-4, fwd_U=1e-4, fwd_J_rel=1e-4,
)


def lowered_has_triton_call(fn, *args) -> bool:
    """True if `jax.jit(fn)` lowers to a Triton custom call, i.e. the
    kernel compiles for the card and is not interpreted."""
    import jax

    return TRITON_CALL in jax.jit(fn).lower(*args).as_text()


def _fleet(prob, defn, batch, dtype, seed, spread):
    import jax
    import jax.numpy as jnp

    from altro_jax.solver.batched import to_batch_last

    rng = np.random.default_rng(seed)
    x0 = np.asarray(defn.x0)[:, None] + rng.uniform(
        -spread, spread, size=(prob.n, batch)
    )
    params = prob.params.replace(x0=jnp.asarray(x0, dtype))
    Z0 = defn.initial_trajectory()
    Zb = to_batch_last(
        jax.tree_util.tree_map(
            lambda l: jnp.broadcast_to(jnp.asarray(l, dtype), (batch,) + l.shape),
            Z0,
        )
    )
    return params, Zb, rng


def verify_compiled_kernels(
    prob, defn, batch: int, *, seed: int = 42, spread: float = 0.1,
    rho: float = 0.0,
) -> dict:
    """Assert that the compiled forward and fused backward kernels match the
    scan oracles at batch width `batch` (the backward kernel only where the
    problem is eligible for it); return the observed deltas and whether
    each kernel lowered to a Triton call.  Raises AssertionError.

    `rho` regularizes the oracle's sweep: a state whose open-loop
    cost-to-go is ill-conditioned in f32 (the quadrotor's) otherwise gets
    gains whose closed-loop rollout amplifies round-off chaotically."""
    import jax
    import jax.numpy as jnp

    from altro_jax import SolverOptions
    from altro_jax.solver.batched import ALSolverBatched

    dtype = jnp.float32
    ref = ALSolverBatched(prob, SolverOptions())
    fast = ALSolverBatched(
        prob, SolverOptions(forward_pass="pallas", backward_pass="fused")
    )
    fwd, bwd = fast._fwd, fast._bwd
    assert fwd is not None, "problem is ineligible for the forward kernel"

    params, Zb, rng = _fleet(prob, defn, batch, dtype, seed, spread)
    Zb = jax.jit(ref.rollout)(params, Zb)
    # warm AL state so the constraint terms are nontrivial
    al = tuple(
        dict(
            lam=jnp.asarray(rng.uniform(-0.5, 0.0, st["lam"].shape), dtype),
            rho=jnp.asarray(rng.uniform(1.0, 10.0, st["rho"].shape), dtype),
        )
        for st in ref.al_state_init(batch, dtype)
    )
    rho_b = jnp.full((batch,), rho, dtype)
    out = {}

    # ---- fused expansion + backward sweep vs expand + riccati_scan
    def oracle_bwd(p, a, Z, r):
        exp = ref.expand(p, a, Z)
        return ref.riccati_scan(exp, r), ref.total_cost(p, a, Z)

    (K0, d0, dV10, _, f0), J00 = jax.jit(oracle_bwd)(params, al, Zb, rho_b)
    out["bwd_failed_lanes"] = int(np.asarray(f0).sum())
    bounds = dict(BOUNDS)
    flags = ["fwd_valid_equal", "fwd_status_equal"]
    calls = ["fwd_triton_call"]
    if bwd is None:
        # e.g. a state too wide for the fused kernel: the solver runs
        # expand + riccati_scan, so there is no backward kernel to check
        out["bwd"] = "ineligible"
        for k in ("K_rel", "d_rel", "dV1_rel", "J0_rel"):
            del bounds[k]
    else:

        def kern_bwd(p, a, Z, r):
            return bwd(p, bwd.pad_al(a), Z, r)

        out["bwd_triton_call"] = lowered_has_triton_call(
            kern_bwd, params, al, Zb, rho_b
        )
        K1, d1, dV11, _, f1, J01 = jax.jit(kern_bwd)(params, al, Zb, rho_b)

        def rel(a, b):
            return float(jnp.abs(a - b).max()) / max(float(jnp.abs(b).max()), 1.0)

        out["K_rel"] = rel(K1, K0)
        out["d_rel"] = rel(d1, d0)
        out["dV1_rel"] = rel(dV11, dV10)
        out["J0_rel"] = float((jnp.abs(J01 - J00) / jnp.abs(J00)).max())
        out["bwd_failed_equal"] = bool(
            np.array_equal(np.asarray(f1), np.asarray(f0))
        )
        flags.append("bwd_failed_equal")
        calls.append("bwd_triton_call")

    # ---- forward rollout + cost vs closed_loop_rollout + total_cost
    alpha = jnp.asarray(rng.choice([1.0, 0.5, 0.25], size=(batch,)), dtype)

    def oracle_fwd(p, a, Z, K, d, al_):
        Zbar, valid, status = ref.closed_loop_rollout(p, Z, K, d, al_)
        return Zbar, valid, status, ref.total_cost(p, a, Zbar)

    Zbar0, valid0, status0, J0 = jax.jit(oracle_fwd)(params, al, Zb, K0, d0, alpha)

    def kern_fwd(p, a, Z, K, d, al_):
        return fwd(p, fwd.pad_al(a), Z, K, d, al_, check_bounds=True)

    out["fwd_triton_call"] = lowered_has_triton_call(
        kern_fwd, params, al, Zb, K0, d0, alpha
    )
    Xn1, U1, J1, valid1, status1 = jax.jit(kern_fwd)(
        params, al, Zb, K0, d0, alpha
    )
    out["fwd_X"] = float(jnp.abs(Xn1 - Zbar0.X[1:]).max())
    out["fwd_U"] = float(jnp.abs(U1 - Zbar0.U).max())
    out["fwd_J_rel"] = float((jnp.abs(J1 - J0) / jnp.abs(J0)).max())
    out["fwd_valid_equal"] = bool(
        np.array_equal(np.asarray(valid1), np.asarray(valid0))
    )
    out["fwd_status_equal"] = bool(
        np.array_equal(np.asarray(status1), np.asarray(status0))
    )

    bad = {k: out[k] for k, bound in bounds.items() if not out[k] <= bound}
    bad.update({k: out[k] for k in flags if not out[k]})
    if jax.default_backend() == "gpu":
        bad.update({k: out[k] for k in calls if not out[k]})
    assert not bad, f"kernel vs oracle out of bounds: {bad} (all: {out})"
    return out


def _to64(tree):
    import jax
    import jax.numpy as jnp

    def cast(leaf):
        leaf = jnp.asarray(leaf)
        if jnp.issubdtype(leaf.dtype, jnp.floating):
            return leaf.astype(jnp.float64)
        return leaf

    return jax.tree_util.tree_map(cast, tree)


def merit_f64(solver, params, al, Z):
    """(merit [B], scale [B]) in f64 of the f32 inputs: the AL merit
    `total_cost`, and the sum of the magnitudes of every term the merit
    adds up — ½|x|ᵀ|Q||x| + |x|ᵀ|H||u| + ½|u|ᵀ|R||u| + |q|ᵀ|x| + |r|ᵀ|u| + |c|
    per cost family and knot, and (‖Π(λ−ρc)‖² + ‖λ‖²)/2ρ per constraint.

    An f32 evaluation of the merit rounds each of those terms, so its error
    is a few unit roundoffs of `scale`, however small the merit itself is:
    near the goal the expanded quadratic's ½xᵀQx, qᵀx and c are each about
    ½ x_fᵀQx_f and cancel to the small tracking cost."""
    import jax
    import jax.numpy as jnp

    from altro_jax.problem.constraints import Cone
    from altro_jax.problem.costs import _quadcost_eval

    prob = solver.prob
    if any(fam.fn is not _quadcost_eval for fam in prob.cost_families):
        raise ValueError("merit scale is defined for quadratic cost families")
    with jax.enable_x64():
        p64, al64, Z64 = _to64(params), _to64(al), _to64(Z)
        merit = solver.total_cost(p64, al64, Z64)
        Zabs = Z64.replace(X=jnp.abs(Z64.X), U=jnp.abs(Z64.U))
        scale = jnp.zeros_like(merit)
        for fam, fp, cp in zip(prob.cost_families, p64.costs, prob.params.costs):
            fabs = jax.tree_util.tree_map(jnp.abs, fp)
            J, _ = solver._quad_terms(fabs, cp, *solver._family_xu(fam, Zabs), False)
            scale = scale + J.sum(axis=0)
        cvals = solver.constraint_values(p64, Z64)
        for fam, st, c in zip(prob.constraint_families, al64, cvals):
            s = st["lam"] - st["rho"][:, None, :] * c
            proj = s if fam.cone is Cone.ZERO else jnp.minimum(s, 0.0)
            both = (proj * proj).sum(axis=1) + (st["lam"] ** 2).sum(axis=1)
            scale = scale + (both / (2.0 * st["rho"])).sum(axis=0)
        return np.asarray(merit), np.asarray(scale)


def verify_kernel_cost(solver, params, al, Z) -> dict:
    """The kernels' f32 AL merit at a given iterate `Z` (a rollout of its
    controls from `params.x0`) — meant for a converged solve's trajectory,
    multipliers and (large) penalties — against
    `total_cost` in f32 and in f64 on the same f32 inputs.

    Bound: |J_f32 − J_f64| ≤ (n + m + 4)·u·scale per lane, u = 2⁻²⁴ and
    `scale` from `merit_f64`: each term is an inner product of at most
    n + m products, and the per-knot sum adds a few more roundings (the
    Kahan-summed knots add none to first order).  The XLA f32 merit is
    held to the same bound, so a kernel that drifts beyond what f32 makes
    unavoidable fails while the oracle passes.  Returns the worst lane's
    errors, relative to the f64 merit and in units of u·scale."""
    import jax
    import jax.numpy as jnp

    prob = solver.prob
    n, m, N = prob.n, prob.m, prob.N
    B = Z.X.shape[-1]
    u = float(np.finfo(np.float32).eps) / 2
    J64, scale = merit_f64(solver, params, al, Z)
    got = {"xla": np.asarray(jax.jit(solver.total_cost)(params, al, Z))}
    fwd, bwd = solver._fwd, solver._bwd
    if fwd is not None:
        zK = jnp.zeros((N, m, n, B), Z.X.dtype)
        zd = jnp.zeros((N, m, B), Z.X.dtype)
        zero = jnp.zeros((B,), Z.X.dtype)
        # K = d = α = 0: the rollout replays U from x0 and costs it
        got["forward"] = np.asarray(jax.jit(
            lambda p, a, Z: fwd(p, fwd.pad_al(a), Z, zK, zd, zero,
                                check_bounds=False)[2]
        )(params, al, Z))
    if bwd is not None:
        got["backward"] = np.asarray(jax.jit(
            lambda p, a, Z: bwd(p, bwd.pad_al(a), Z, jnp.zeros((B,), Z.X.dtype))[5]
        )(params, al, Z))
    bound = (n + m + 4) * u * scale
    out = {"max_rho": max(float(jnp.max(st["rho"])) for st in al),
           "max_abs_lam": max(float(jnp.max(jnp.abs(st["lam"]))) for st in al)}
    bad = {}
    for name, J in got.items():
        err = np.abs(J.astype(np.float64) - J64)
        out[f"{name}_rel"] = float(np.max(err / np.abs(J64)))
        out[f"{name}_ulps_of_scale"] = float(np.max(err / (u * scale)))
        if not np.all(err <= bound):
            bad[name] = out[f"{name}_ulps_of_scale"]
    out["bound_ulps_of_scale"] = n + m + 4
    assert not bad, f"f32 merit beyond its rounding bound: {bad} (all: {out})"
    return out
