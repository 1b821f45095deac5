#!/usr/bin/env python
"""Batched scenario sweep: thousands of randomized parking problems as one
program (BASELINE config "batched scenario sweep ... sharded over a mesh").

Uses the native threaded scenario generator to build the batch and the
batch-native solver (lane-major layout) to solve it.  Pass `cpu` to run on
the host, and `--batch N` to size the sweep.
"""
import sys
import time

import jax

if "cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from altro_jax import SolverOptions
from altro_jax.models.problems import UnicycleProblem
from altro_jax.native import ScenarioGenerator
from altro_jax.solver.batched import ALSolverBatched, to_batch_last


def main():
    batch = 1024
    if "--batch" in sys.argv:
        batch = int(sys.argv[sys.argv.index("--batch") + 1])
    defn = UnicycleProblem(dtype=jnp.float32)
    prob = defn.make_problem(add_constraints=True).compile()
    solver = ALSolverBatched(prob, SolverOptions())
    solve = jax.jit(solver.solve)

    gen = ScenarioGenerator(nthreads=8)
    x0s = gen.uniform(batch, [-0.1, -0.1, -0.1], [0.1, 0.1, 0.1], seed=0)
    params_b = prob.params.replace(x0=jnp.asarray(x0s.T))
    Z0 = defn.initial_trajectory()
    Zb = to_batch_last(
        jax.tree_util.tree_map(
            lambda leaf: jnp.broadcast_to(leaf, (batch,) + leaf.shape), Z0
        )
    )

    res = solve(params_b, Zb)
    jax.block_until_ready(res["Z"].U)
    t0 = time.perf_counter()
    res = solve(params_b, Zb)
    jax.block_until_ready(res["Z"].U)
    dt = time.perf_counter() - t0
    solved = int(jnp.sum(res["status"] == 0))
    print(f"batch {batch}: {solved}/{batch} solved in {dt:.3f}s "
          f"-> {batch / dt:.0f} solves/s on {jax.devices()[0]}")


if __name__ == "__main__":
    main()
