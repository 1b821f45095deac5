#!/usr/bin/env python
"""Receding-horizon MPC demo: warm-started unicycle re-solves in a closed
loop (BASELINE config "receding-horizon MPC loop ... at 100 Hz budget")."""
import sys
import time

import jax

if "cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

from altro_jax import SolverOptions
from altro_jax.models.problems import UnicycleProblem
from altro_jax.models.unicycle import unicycle_rk4
from altro_jax.solver.mpc import MPC


def main(steps: int = 60):
    defn = UnicycleProblem()
    prob = defn.make_problem(add_constraints=True).compile()
    mpc = MPC(prob, SolverOptions(), shift=True)
    model = unicycle_rk4()

    state = mpc.init(defn.initial_trajectory())
    x = jnp.zeros(3)
    lat = []
    for k in range(steps):
        t0 = time.perf_counter()
        u0, state = mpc.step(state, x)
        jax.block_until_ready(u0)
        lat.append((time.perf_counter() - t0) * 1e3)
        x = model(x, u0, 0.0, defn.h)
    lat = np.asarray(lat[3:])  # skip warmup
    print(f"steps: {steps}, final dist to goal: "
          f"{float(jnp.linalg.norm(x - jnp.asarray(defn.xf))):.4f} m")
    print(f"re-solve latency: median {np.median(lat):.2f} ms, "
          f"p95 {np.percentile(lat, 95):.2f} ms  (100 Hz budget = 10 ms)")
    print(f"within budget: {(lat < 10.0).mean() * 100:.1f}%")


if __name__ == "__main__":
    main()
