"""Receding-horizon MPC tests (BASELINE config: warm-started re-solves).

Mirrors the reference's warm-start semantics tests
(`auglag_test.cpp:353-380`) and its MPC-style benchmark loop
(`perf/benchmark_unicycle.cpp:45-75`).
"""
import jax
import jax.numpy as jnp
import numpy as np

from altro_jax import SolverOptions, SolverStatus
from altro_jax.models.problems import UnicycleProblem
from altro_jax.models.unicycle import unicycle_rk4
from altro_jax.solver.mpc import MPC


def test_mpc_drives_unicycle_to_goal():
    defn = UnicycleProblem()
    prob = defn.make_problem(add_constraints=True).compile()
    opts = SolverOptions()
    mpc = MPC(prob, opts, shift=True)
    model = unicycle_rk4()

    state = mpc.init(defn.initial_trajectory())
    x = jnp.zeros(3)
    iters = []
    for k in range(30):
        u0, state = mpc.step(state, x)
        assert int(state.status) == SolverStatus.SOLVED
        iters.append(int(state.iterations))
        # simulate the plant one step with the commanded control
        x = model(x, u0, 0.0, defn.h)
    # warm-started re-solves converge much faster than the cold solve
    assert iters[0] > iters[-1]
    assert np.mean(iters[5:]) <= 4
    # the controller is actually driving toward the goal
    assert np.linalg.norm(np.asarray(x - jnp.asarray(defn.xf))) < np.linalg.norm(
        np.asarray(defn.xf)
    )


def test_mpc_no_retrace_across_steps():
    defn = UnicycleProblem()
    prob = defn.make_problem(add_constraints=True).compile()
    mpc = MPC(prob, SolverOptions(), shift=True)
    state = mpc.init(defn.initial_trajectory())
    u0, state = mpc.step(state, jnp.zeros(3))
    n0 = mpc._solve._cache_size()
    for _ in range(3):
        u0, state = mpc.step(state, jnp.asarray([0.01, 0.02, 0.0]))
    assert mpc._solve._cache_size() == n0  # single compilation serves the loop
