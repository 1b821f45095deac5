#!/usr/bin/env python
"""How wide a state the fused backward kernel compiles for, on a GPU.

The fused backward kernel unrolls each lane's RK4 Jacobian chain rule and
Riccati products, about n³ scalar operations per knot, and Triton's compile
time grows with it.  For each zoo problem this script builds the kernel
with the state-width cutoff lifted, times its lowering and compile, and
checks its gains against the scan oracle (`child`), each problem in its
own process under a time limit, one process at a time:

    python perf/backward_compile_limit.py [--timeout 150] [--batch 1024]
                                          [--only NAME] [--out FILE.jsonl]

`BackwardFusedKernel.max_state_dim` is set from these readings.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

PROBLEMS = ("parking", "cartpole", "triple_integrator_6", "triple_integrator_9")


class _Defn:
    """The two attributes `verify_compiled_kernels` reads from a problem
    definition."""

    def __init__(self, x0, Z0):
        self.x0 = x0
        self._Z0 = Z0

    def initial_trajectory(self):
        return self._Z0


def build(name):
    import jax.numpy as jnp
    import numpy as np

    from altro_jax.models.problems import TripleIntegratorProblem, UnicycleProblem

    if name == "parking":
        defn = UnicycleProblem(dtype=jnp.float32)
        return defn.make_problem(add_constraints=True).compile(), defn
    if name == "cartpole":
        from perf.benchmark_zoo import build_cartpole

        prob, Z0, x0, _ = build_cartpole()
        return prob, _Defn(np.asarray(x0), Z0)
    dof = {"triple_integrator_6": 2, "triple_integrator_9": 3}[name]
    defn = TripleIntegratorProblem(dof=dof, N=50, dtype=jnp.float32)
    return defn.make_problem(add_constraints=True).compile(), defn


def child(name: str, batch: int) -> dict:
    """Lower, compile and check the fused backward kernel for one problem.

    The check is against the f64 oracle (`expand` + `riccati_scan` in f64
    on the same f32 inputs): the kernel's K and d may be no further from it
    than four times the f32 oracle's own distance (plus 1e-6), and the
    failure flags must match the f32 oracle's.  Ill-conditioned problems
    (Qf = 1e5, a swing-up) move both f32 sweeps far from the f64 one, so a
    fixed f32-vs-f32 bound would measure the conditioning, not the kernel."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from altro_jax import SolverOptions
    from altro_jax.ops.backward_fused_pallas import BackwardFusedKernel
    from altro_jax.ops.forward_pallas import kernel_interpret
    from altro_jax.solver.batched import ALSolverBatched, to_batch_last
    from perf.verify_kernels import _to64, lowered_has_triton_call

    BackwardFusedKernel.max_state_dim = 64
    prob, defn = build(name)
    rec = dict(problem=name, n=prob.n, m=prob.m, N=prob.N, batch=batch)
    bwd = BackwardFusedKernel(prob, SolverOptions(), interpret=kernel_interpret())
    ref = ALSolverBatched(prob, SolverOptions())
    Z = to_batch_last(jax.tree_util.tree_map(
        lambda l: jnp.broadcast_to(jnp.asarray(l, jnp.float32), (batch,) + l.shape),
        defn.initial_trajectory(),
    ))
    rng = np.random.default_rng(0)
    x0 = np.asarray(defn.x0)[:, None] + rng.uniform(-0.05, 0.05, (prob.n, batch))
    params = prob.params.replace(x0=jnp.asarray(x0, jnp.float32))
    Z = jax.jit(ref.rollout)(params, Z)
    al = tuple(
        dict(lam=jnp.asarray(rng.uniform(-0.5, 0.0, st["lam"].shape), jnp.float32),
             rho=jnp.asarray(rng.uniform(1.0, 10.0, st["rho"].shape), jnp.float32))
        for st in ref.al_state_init(batch, jnp.float32)
    )
    rho = jnp.zeros((batch,), jnp.float32)
    kern = lambda p, a, Z, r: bwd(p, bwd.pad_al(a), Z, r)
    t0 = time.perf_counter()
    lowered = jax.jit(kern).lower(params, al, Z, rho)
    rec["lower_s"] = time.perf_counter() - t0
    rec["triton_call"] = lowered_has_triton_call(kern, params, al, Z, rho)
    t0 = time.perf_counter()
    compiled = lowered.compile()
    rec["compile_s"] = time.perf_counter() - t0
    K, d, _, _, failed, _ = compiled(params, al, Z, rho)

    def oracle(p, a, Z, r):
        return ref.riccati_scan(ref.expand(p, a, Z), r)

    K32, d32, _, _, failed32 = jax.jit(oracle)(params, al, Z, rho)
    with jax.enable_x64():
        K64, d64, *_ = jax.jit(oracle)(*_to64((params, al, Z, rho)))
        K64, d64 = np.asarray(K64), np.asarray(d64)

    def dist(a, b):
        a = np.asarray(a, np.float64)
        return float(np.abs(a - b).max() / max(np.abs(b).max(), 1.0))

    for key, got, f32, f64 in (("K", K, K32, K64), ("d", d, d32, d64)):
        rec[f"{key}_kernel_vs_f64"] = dist(got, f64)
        rec[f"{key}_oracle32_vs_f64"] = dist(f32, f64)
    rec["failed_equal"] = bool(np.array_equal(np.asarray(failed), np.asarray(failed32)))
    rec["failed_lanes"] = int(np.asarray(failed32).sum())
    rec["verified"] = rec["failed_equal"] and all(
        rec[f"{k}_kernel_vs_f64"] <= 4 * rec[f"{k}_oracle32_vs_f64"] + 1e-6
        for k in ("K", "d")
    )
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--timeout", type=float, default=150.0)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--only", help="run this problem in this process")
    ap.add_argument("--out", help="also append the JSON lines to this file")
    args = ap.parse_args()
    if args.only:
        import jax

        if jax.default_backend() != "gpu":
            print("backward_compile_limit: needs a GPU", file=sys.stderr)
            return 2
        print(json.dumps(child(args.only, args.batch)), flush=True)
        return 0
    rc = 0
    for name in PROBLEMS:
        t0 = time.perf_counter()
        try:
            p = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--only", name,
                 "--batch", str(args.batch)],
                capture_output=True, text=True, timeout=args.timeout,
            )
            lines = p.stdout.strip().splitlines()
            rec = json.loads(lines[-1]) if p.returncode == 0 and lines else dict(
                problem=name, rc=p.returncode, stderr=p.stderr[-2000:]
            )
        except subprocess.TimeoutExpired:
            rec = dict(problem=name, timeout_s=args.timeout)
        rec["wall_s"] = time.perf_counter() - t0
        if not rec.get("verified"):
            rc = 1
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as log:
                log.write(line + "\n")
    return rc


if __name__ == "__main__":
    sys.exit(main())
