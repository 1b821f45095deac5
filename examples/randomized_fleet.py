#!/usr/bin/env python
"""Randomized fleet demo: per-instance problems through one batched solve.

The r4 fleet workflow (BASELINE config 5): every instance gets its own
initial state, obstacle layout, and goal reference by giving the param
leaves a TRAILING batch axis (the `batch_axes` convention); the fused
Pallas kernels read per-instance leaves as lane vectors, and the compacted
solver's f64 polish finishes the f32 precision-floor residue.  On CPU this
runs the same program in interpret/scan mode.

Run:  PYTHONPATH=. JAX_PLATFORMS=cpu python examples/randomized_fleet.py
      (drop JAX_PLATFORMS on a GPU machine)
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np

from altro_jax import SolverOptions, SolverStatus
from altro_jax.models.problems import UnicycleProblem
from altro_jax.solver.batched import to_batch_last
from altro_jax.solver.compaction import CompactedALSolver

B = int(sys.argv[1]) if len(sys.argv) > 1 else 64

defn = UnicycleProblem(scenario="three_obstacles", dtype=jnp.float32)
prob = defn.make_problem(add_constraints=True).compile()
rng = np.random.default_rng(0)

# --- per-instance problem data: trailing batch axis on any param leaf ---
cx0, cy0, r0 = defn.obstacles
cons = list(prob.params.constraints)
ci = next(i for i, f in enumerate(prob.constraint_families)
          if f.constraint.structure[0] == "circle")
cons[ci] = dict(
    cons[ci],
    cx=jnp.asarray(cx0[:, None] + rng.uniform(-0.2, 0.2, (3, B)), jnp.float32),
    cy=jnp.asarray(cy0[:, None] + rng.uniform(-0.2, 0.2, (3, B)), jnp.float32),
)
xf = np.broadcast_to(defn.xf[:, None], (3, B)).copy()
xf[0] += rng.uniform(0.0, 0.3, B)
xf[1] += rng.uniform(0.0, 0.3, B)
xf = jnp.asarray(xf, jnp.float32)
gi = next(i for i, f in enumerate(prob.constraint_families)
          if f.constraint.structure[0] == "goal")
cons[gi] = dict(cons[gi], xf=xf)
# the tracking cost's references follow the goal (lqr_cost: q=-Qxf, c=½xfᵀQxf)
cp0 = prob.params.costs[0]
Q = jnp.asarray(cp0["Q"], jnp.float32)
params = prob.params.replace(
    x0=jnp.asarray(rng.uniform(-0.1, 0.1, (3, B)), jnp.float32),
    constraints=tuple(cons),
    costs=(dict(cp0,
                q=-jnp.einsum("kij,jb->kib", Q, xf),
                c=0.5 * jnp.einsum("ib,kij,jb->kb", xf, Q, xf)),),
)

Z0 = defn.initial_trajectory()
Zb = to_batch_last(jax.tree_util.tree_map(
    lambda l: jnp.broadcast_to(l, (B,) + l.shape), Z0))

solver = CompactedALSolver(
    prob,
    SolverOptions(initial_penalty=1.0, line_search_max_iterations=20,
                  max_stall_iterations=10, outer_constraints_f64=True),
    phase1_iters=14, tail_batch=min(1024, B),
    # r5: single-dispatch device pipeline + all-f32 fresh-restart cascade
    # (each penalty-ladder variant retries whatever the earlier ones
    # failed) + structural infeasibility certificates
    device_tail=True,
    restart_portfolio=(
        dict(),
        dict(penalty_scaling=4.0, max_iterations_outer=60,
             max_iterations_total=900),
        dict(penalty_scaling=1.5, max_iterations_outer=120,
             max_iterations_total=1100),
    ),
    restart_width=min(1024, B),
    detect_infeasible=True,
    infeasible_step_bound=float(defn.v_bnd * defn.tf / defn.N),
)
res = solver.solve(params, Zb)
status = np.asarray(res["status"])
hist = {SolverStatus(c).name: int((status == c).sum())
        for c in sorted(set(status.tolist()))}
print(f"fleet of {B}: {hist}")
X = np.asarray(res["Z"].X, np.float64)
cx = np.asarray(cons[ci]["cx"]); cy = np.asarray(cons[ci]["cy"])
rr = np.asarray(prob.params.constraints[ci]["r"])[:, None]
d = np.sqrt((X[:, 0, None, :] - cx[None]) ** 2
            + (X[:, 1, None, :] - cy[None]) ** 2) - rr[None]
print(f"min clearance vs own layout: {d.min(axis=(0, 1)).min():+.4f} m")
goal_err = np.abs(X[-1] - np.asarray(xf)).max(axis=0)
print(f"goal error p99: {np.percentile(goal_err, 99):.5f}")
print("iters p50/p99:", solver.telemetry["iters_p50"],
      solver.telemetry["iters_p99"])
