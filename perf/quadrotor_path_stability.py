#!/usr/bin/env python
"""Root-cause experiment for the order-dependent quadrotor failure (r4).

VERDICT r3 Weak #1: `test_quadrotor_waypoint` failed (NaN gains,
STATE_LIMIT) in two independent full-suite runs but passes in isolation;
the r3 hazard note blamed interference from a concurrent accelerator
process, which a clean CPU run refuted.  This experiment establishes the actual mechanism:

1. The solve operates in the Cholesky-retry regime: final regularization
   ~0.9 (vs the 1e-8 floor), i.e. the backward pass repeatedly hits
   indefinite Quu and relies on the retry loop.
2. In that regime the ITERATION PATH is sensitive to sub-ulp numeric
   differences: compiling the identical program with
   `--xla_cpu_multi_thread_eigen=false` (a codegen-only flag) changes the
   solve from 19 to 16 iterations with a different endpoint hash.  Input
   perturbations at 1e-13..1e-6 do NOT flip the outcome (30/30 SOLVED
   each), so the solve is robust to data, fragile only in path.
3. The failure signature (unbounded gains -> every line-search rollout
   trips the ‖x‖>1e8 divergence guard -> STATE_LIMIT hard abort) matches a
   structural hole: a finite-but-numerically-singular regularized Quu
   passes the NaN-only Cholesky check (Eigen LLT has the same hole) and
   emits astronomically large K/d.  On an unlucky numeric path this
   converts a should-be-regularization-retry into an abort.

Fix (r4): `SolverOptions.bp_gain_limit` — gains above the rollout guard's
own scale (1e8) count as backward-pass failure in EVERY sweep
implementation (sequential scan, batched scan, Pallas, fused, pscan), so
the bad path retries with increased regularization instead of aborting.

Run on CPU: PYTHONPATH=. python perf/quadrotor_path_stability.py
"""
import json
import os
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r"""
import hashlib
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
from altro_jax import (ALSolver, Problem, SolverOptions, SolverStatus,
                       control_bound, initial_trajectory, lqr_cost)
from altro_jax.models.quadrotor import hover_controls, hover_state, quadrotor_rk4

N, h = 60, 0.05
model = quadrotor_rk4()
x0 = hover_state((0.0, 0.0, 1.0)); xf = hover_state((2.0, 0.0, 2.0))
u_hover = hover_controls()
Q = jnp.diag(jnp.concatenate([jnp.full(3, 1e-2), jnp.full(4, 1e-2),
                              jnp.full(3, 1e-2), jnp.full(3, 1e-2)])) * h
R = jnp.eye(4) * 1e-2 * h
Qf = jnp.eye(13) * 100.0
prob = Problem(N)
prob.set_dynamics(model, range(N))
prob.set_cost(lqr_cost(Q, R, xf, u_hover), range(N))
prob.set_cost(lqr_cost(Qf, jnp.zeros((4, 4)), xf, terminal=True), N)
prob.set_constraint(control_bound([0.0] * 4, [4.0] * 4), range(N))
prob.set_initial_state(x0)
cp = prob.compile()
solver = ALSolver(cp, SolverOptions())
Z0 = initial_trajectory(13, 4, N, h, u0=u_hover)
res = solver.solve(cp.params, Z0)
U = np.asarray(res.Z.U, np.float64)
print(int(res.status), int(res.stats.iterations_total),
      float(res.stats.regularization),
      hashlib.sha256(U.tobytes()).hexdigest()[:16])
"""


def run_child(extra_flags=""):
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO
    if extra_flags:
        env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " " + extra_flags).strip()
    out = subprocess.run(
        [sys.executable, "-c", _CHILD], env=env, capture_output=True,
        text=True, timeout=900,
    )
    line = out.stdout.strip().splitlines()[-1]
    status, iters, reg, h = line.split()
    return dict(status=int(status), iterations=int(iters),
                final_reg=float(reg), U_hash=h)


def main() -> None:
    base = run_child()
    alt = run_child("--xla_cpu_multi_thread_eigen=false")
    print(json.dumps({"config": "default", **base}))
    print(json.dumps({"config": "xla_cpu_multi_thread_eigen=false", **alt}))
    print(json.dumps({
        "path_unstable": base["U_hash"] != alt["U_hash"]
        or base["iterations"] != alt["iterations"],
        "in_chol_retry_regime": base["final_reg"] > 1e-6,
        "note": (
            "identical f64 program, codegen-only flag change -> different "
            "iteration path; combined with the pre-r4 NaN-only Cholesky "
            "failure check this is the order-dependent failure mechanism "
            "(see module docstring); bp_gain_limit closes the hole"
        ),
    }))


if __name__ == "__main__":
    main()
