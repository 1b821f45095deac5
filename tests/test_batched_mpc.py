"""BatchedMPC: warm-started lane-major fleet re-solves.

The reference's MPC workflow is a warm-started re-solve loop
(`perf/benchmark_unicycle.cpp:45-75`); `BatchedMPC` is its fleet analog on
the batch-native solver.  These tests pin: (a) the fleet controller drives
every instance to the goal, (b) warm-started re-solves converge in fewer
iterations than cold solves (the point of warm starting), and (c) the
fleet step agrees with the per-instance `MPC` controller.
"""
import jax
import jax.numpy as jnp
import numpy as np

from altro_jax import MPC, BatchedMPC, SolverOptions, SolverStatus
from altro_jax.models.problems import UnicycleProblem
from altro_jax.models.unicycle import unicycle_rk4
from altro_jax.solver.batched import to_batch_last

B = 4


def _setup():
    defn = UnicycleProblem(dtype=jnp.float64)
    prob = defn.make_problem(add_constraints=True).compile()
    Z0 = defn.initial_trajectory()
    Zb = to_batch_last(
        jax.tree_util.tree_map(lambda l: jnp.broadcast_to(l, (B,) + l.shape), Z0)
    )
    return defn, prob, Z0, Zb


def test_batched_mpc_closed_loop_reaches_goal():
    defn, prob, Z0, Zb = _setup()
    mpc = BatchedMPC(prob, SolverOptions())
    state = mpc.init(Zb)
    rng = np.random.default_rng(0)
    xB = jnp.asarray(rng.uniform(-0.05, 0.05, size=(3, B)), jnp.float64)
    model = jax.vmap(
        lambda x, u: unicycle_rk4()(x, u, 0.0, defn.h), in_axes=-1, out_axes=-1
    )
    d0 = np.linalg.norm(np.asarray(xB - jnp.asarray(defn.xf)[:, None]), axis=0)
    for _ in range(40):
        u0, state = mpc.step(state, xB)
        assert u0.shape == (2, B)
        xB = model(xB, u0)
    # every instance solved at the last tick and moved toward the goal
    assert np.all(np.asarray(state.status) == int(SolverStatus.SOLVED))
    d = np.linalg.norm(np.asarray(xB - jnp.asarray(defn.xf)[:, None]), axis=0)
    assert np.all(d < 0.5 * d0), (d, d0)


def test_warm_start_cuts_iterations():
    defn, prob, Z0, Zb = _setup()
    mpc = BatchedMPC(prob, SolverOptions(), shift=False)
    state = mpc.init(Zb)
    x0 = jnp.zeros((3, B), jnp.float64)
    _, state1 = mpc.step(state, x0)
    cold = np.asarray(state1.iterations)
    _, state2 = mpc.step(state1, x0)
    warm = np.asarray(state2.iterations)
    assert np.all(warm < cold), (warm, cold)
    assert np.all(np.asarray(state2.status) == int(SolverStatus.SOLVED))


def test_fleet_matches_per_instance_controller():
    defn, prob, Z0, Zb = _setup()
    fleet = BatchedMPC(prob, SolverOptions())
    single = MPC(prob, SolverOptions())
    sf = fleet.init(Zb)
    ss = single.init(Z0)
    x = jnp.zeros(3, jnp.float64)
    xB = jnp.zeros((3, B), jnp.float64)
    for _ in range(3):
        uB, sf = fleet.step(sf, xB)
        u1, ss = single.step(ss, x)
        np.testing.assert_allclose(
            np.asarray(uB[:, 0]), np.asarray(u1), rtol=0, atol=1e-8
        )
