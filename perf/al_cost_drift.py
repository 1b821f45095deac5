"""Where the solver's f32 running cost departs from the f64 reference.

`stats.cost` is the AL merit of the last accepted forward pass: the
objective plus (‖Π(λ−ρc)‖² − ‖λ‖²)/2ρ per constraint, at the multipliers
of the last outer iteration.  This script runs the parity solve
(`bench.parity_solve`'s config) and, after every inner solve, splits lane
0's cost into

  * `stats_cost`   the solver's own f32 value (kernel or scan);
  * `xla_f32`      `total_cost` in f32 at the same (Z, λ, ρ);
  * `merit_f64`    the same merit in f64 from the same f32 inputs;
  * `obj_f64`      the objective alone, in f64;

  * `merit_f64_params` the merit in f64 with the parameters built in f64;

so `stats_cost` − `merit_f64` is the rounding of the f32 evaluation (in
units of u·scale, `perf/verify_kernels.merit_f64`), `merit_f64` −
`merit_f64_params` the rounding of the f32 parameters, and
`merit_f64_params` − J_ref the iterate's own AL term and objective.

    python perf/al_cost_drift.py [--batch B] [--scan]
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run(batch: int, scan: bool) -> list[dict]:
    import jax
    import jax.numpy as jnp

    import bench
    from altro_jax.models.problems import UnicycleProblem
    from altro_jax.solver.batched import ALSolverBatched, to_batch_last

    defn = UnicycleProblem(dtype=jnp.float32)
    prob = defn.make_problem(add_constraints=True).compile()
    opts = bench.parity_options()
    if scan:
        opts = opts.replace(backward_pass="scan", forward_pass="scan")
    rows: list[dict] = []

    def record(cost, xla32, Z0x, Z0u, lams, rhos):
        rows.append(dict(
            stats_cost=float(cost), xla_f32=float(xla32),
            X=np.asarray(Z0x, np.float64), U=np.asarray(Z0u, np.float64),
            lam=[np.asarray(l, np.float64) for l in lams],
            rho=[np.asarray(r, np.float64) for r in rhos],
        ))

    class Probe(ALSolverBatched):
        def ilqr_solve(self, params, al, Z, stats, outer_active, lane_opts=None):
            out = super().ilqr_solve(
                params, al, Z, stats, outer_active, lane_opts
            )
            xla32 = self.total_cost(params, al, out["Z"])
            jax.debug.callback(
                record, out["stats"].cost[0], xla32[0],
                out["Z"].X[..., 0], out["Z"].U[..., 0],
                [st["lam"][..., 0] for st in al],
                [st["rho"][..., 0] for st in al],
            )
            return out

    solver = Probe(prob, opts)
    Zb = to_batch_last(jax.tree_util.tree_map(
        lambda l: jnp.broadcast_to(l, (batch,) + l.shape),
        defn.initial_trajectory(),
    ))
    params = prob.params.replace(x0=jnp.zeros((3, batch), jnp.float32))
    res = jax.jit(solver.solve)(params, Zb)
    jax.block_until_ready(res["Z"].U)

    from perf.verify_kernels import merit_f64

    _, _, J_ref = bench.load_reference_golden(
        "unicycle_turn90_refsolve_f64_tol6.npz"
    )
    with jax.enable_x64():
        defn64 = UnicycleProblem(dtype=jnp.float64)
        prob64 = defn64.make_problem(add_constraints=True).compile()
        ref64 = ALSolverBatched(prob64, opts.replace(
            backward_pass="scan", forward_pass="scan"
        ))
    u = float(np.finfo(np.float32).eps) / 2
    out = []
    for r in rows:
        Z = to_batch_last(jax.tree_util.tree_map(
            lambda l: jnp.asarray(l)[None], defn.initial_trajectory()
        ))
        Z = Z.replace(
            X=jnp.asarray(r["X"], jnp.float32)[..., None],
            U=jnp.asarray(r["U"], jnp.float32)[..., None],
        )
        al = tuple(
            dict(lam=jnp.asarray(l, jnp.float32)[..., None],
                 rho=jnp.asarray(p, jnp.float32)[..., None])
            for l, p in zip(r["lam"], r["rho"])
        )
        p32 = prob.params.replace(x0=jnp.zeros((3, 1), jnp.float32))
        # the f32 problem's merit, evaluated in f64: isolates the rounding
        # of the f32 evaluation from the rounding of the f32 parameters
        m32p, scale = merit_f64(solver, p32, al, Z)
        with jax.enable_x64():
            p64 = prob64.params.replace(x0=jnp.zeros((3, 1), jnp.float64))
            m64p, _ = merit_f64(ref64, p64, al, Z)
        m32p, m64p, scale = float(m32p[0]), float(m64p[0]), float(scale[0])
        out.append(dict(
            stats_cost=r["stats_cost"], xla_f32=r["xla_f32"],
            merit_f64=m32p, merit_f64_params=m64p, J_ref=J_ref,
            obj_f64=_objective(defn, r["X"], r["U"]),
            u_scale=u * scale,
            rho_max=max(float(p.max()) for p in r["rho"]),
            lam_max=max(float(np.abs(l).max()) for l in r["lam"]),
            # f32 evaluation error, in units of u·scale
            stats_ulps=(r["stats_cost"] - m32p) / (u * scale),
            xla_ulps=(r["xla_f32"] - m32p) / (u * scale),
            # rounding of the parameters to f32
            params_rel=(m32p - m64p) / J_ref,
            # the iterate's own AL term and objective vs the reference
            merit_vs_ref=(m64p - J_ref) / J_ref,
            stats_vs_ref=(r["stats_cost"] - J_ref) / J_ref,
        ))
    return out

    solver = Probe(prob, opts)
    Zb = to_batch_last(jax.tree_util.tree_map(
        lambda l: jnp.broadcast_to(l, (batch,) + l.shape),
        defn.initial_trajectory(),
    ))
    params = prob.params.replace(x0=jnp.zeros((3, batch), jnp.float32))
    res = jax.jit(solver.solve)(params, Zb)
    jax.block_until_ready(res["Z"].U)

    # the f64 merit of each recorded iterate, on the host's CPU
    with jax.enable_x64():
        cpu = jax.devices("cpu")[0]
        defn64 = UnicycleProblem(dtype=jnp.float64)
        prob64 = defn64.make_problem(add_constraints=True).compile()
        ref64 = ALSolverBatched(prob64, opts.replace(
            backward_pass="scan", forward_pass="scan"
        ))
        _, _, J_ref = bench.load_reference_golden(
            "unicycle_turn90_refsolve_f64_tol6.npz"
        )
        out = []
        for r in rows:
            with jax.default_device(cpu):
                Z = to_batch_last(jax.tree_util.tree_map(
                    lambda l: jnp.asarray(l, jnp.float64)[None],
                    defn64.initial_trajectory(),
                ))
                Z = Z.replace(
                    X=jnp.asarray(r["X"])[..., None],
                    U=jnp.asarray(r["U"])[..., None],
                )
                al = tuple(
                    dict(lam=jnp.asarray(l)[..., None], rho=jnp.asarray(p)[..., None])
                    for l, p in zip(r["lam"], r["rho"])
                )
                p64 = prob64.params.replace(x0=jnp.zeros((3, 1), jnp.float64))
                merit = float(ref64.total_cost(p64, al, Z)[0])
                obj = _objective(defn64, r["X"], r["U"])
            out.append(dict(
                stats_cost=r["stats_cost"], xla_f32=r["xla_f32"],
                merit_f64=merit, obj_f64=obj, J_ref=J_ref,
                rho_max=max(float(p.max()) for p in r["rho"]),
                lam_max=max(float(np.abs(l).max()) for l in r["lam"]),
                stats_vs_merit=(r["stats_cost"] - merit) / J_ref,
                merit_vs_ref=(merit - J_ref) / J_ref,
                obj_vs_ref=(obj - J_ref) / J_ref,
            ))
    return out


def _objective(defn, X, U) -> float:
    """The parking problem's quadratic objective (stage + terminal LQR
    costs, `UnicycleProblem.make_problem`) of one trajectory, in f64."""
    dx = X - np.asarray(defn.xf, np.float64)[None]
    Q = np.asarray(defn.Q, np.float64)
    R = np.asarray(defn.R, np.float64)
    Qf = np.asarray(defn.Qf, np.float64)
    stage = 0.5 * np.einsum("ki,ij,kj->", dx[:-1], Q, dx[:-1])
    stage += 0.5 * np.einsum("ki,ij,kj->", U, R, U)
    return float(stage + 0.5 * dx[-1] @ Qf @ dx[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--scan", action="store_true",
                    help="all-scan config instead of the shipped kernels")
    args = ap.parse_args()
    for row in run(args.batch, args.scan):
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
