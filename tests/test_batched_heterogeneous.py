"""Heterogeneous dynamics through the BATCHED solver (r4, VERDICT #8).

The reference accepts a distinct model per knot point
(`problem.hpp:159-183`); the general per-instance solver always matched
(tests/test_general_problems.py), but `ALSolverBatched` raised
NotImplementedError for >1 dynamics family or per-knot dynamics params.
r4 lifts that on the scan path: per-knot `lax.switch` dispatch in the
rollouts (`_dyn_step_k`) and per-family Jacobian scatter
(`dyn_jacobian_all`).  Oracle = the per-instance `ALSolver` on each batch
element.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from altro_jax import (
    ALSolver,
    ContinuousModel,
    Problem,
    SolverOptions,
    SolverStatus,
    goal_constraint,
    initial_trajectory,
    lqr_cost,
)
from altro_jax.models.triple_integrator import triple_integrator_rk4
from altro_jax.problem.dynamics import discretize
from altro_jax.solver.batched import ALSolverBatched, to_batch_last

B = 8


def _hybrid_problem(N=20):
    """First half triple integrator, second half damped variant — the same
    hybrid system the per-instance test uses."""
    tri = triple_integrator_rk4(dof=1)

    def damped_fn(params, x, u, t):
        return jnp.concatenate([x[1:2], x[2:3] - params["c"] * x[1:2], u])

    damped = discretize(
        ContinuousModel(params={"c": jnp.asarray(0.5)}, fn=damped_fn, n=3, m=1),
        "rk4",
    )
    prob = Problem(N)
    prob.set_dynamics(tri, range(N // 2))
    prob.set_dynamics(damped, range(N // 2, N))
    xf = jnp.array([1.0, 0.0, 0.0])
    prob.set_cost(lqr_cost(jnp.eye(3), jnp.eye(1) * 0.01, xf), range(N))
    prob.set_cost(
        lqr_cost(jnp.eye(3) * 1e4, jnp.zeros((1, 1)), xf, terminal=True), N
    )
    prob.set_constraint(goal_constraint(xf), N)
    prob.set_initial_state(jnp.array([-1.0, 0.0, 0.0]))
    return prob.compile(), xf


def _batch(cp, N, h, seed=0):
    rng = np.random.default_rng(seed)
    x0s = jnp.asarray(
        np.array([-1.0, 0.0, 0.0])[:, None]
        + rng.uniform(-0.2, 0.2, (3, B))
    )
    params = cp.params.replace(x0=x0s)
    Z0 = initial_trajectory(3, 1, N, h)
    Zb = to_batch_last(
        jax.tree_util.tree_map(
            lambda l: jnp.broadcast_to(l, (B,) + l.shape), Z0
        )
    )
    return params, Zb, x0s, Z0


def test_hybrid_dynamics_batched_matches_per_instance_oracle():
    N, h = 20, 0.1
    cp, xf = _hybrid_problem(N)
    assert len(cp.dynamics_families) == 2
    params, Zb, x0s, Z0 = _batch(cp, N, h)

    fast = ALSolverBatched(cp, SolverOptions())
    res = jax.jit(fast.solve)(params, Zb)
    status = np.asarray(res["status"])
    assert np.all(status == int(SolverStatus.SOLVED)), status

    oracle = ALSolver(cp, SolverOptions())
    for b in range(3):
        pb = cp.params.replace(x0=x0s[:, b])
        ob = oracle.solve(pb, Z0)
        assert int(ob.status) == int(SolverStatus.SOLVED)
        np.testing.assert_allclose(
            np.asarray(res["Z"].U[..., b]), np.asarray(ob.Z.U),
            rtol=1e-6, atol=1e-8,
        )
        assert int(np.asarray(res["stats"].iterations_total[b])) == int(
            ob.stats.iterations_total
        )


def test_hybrid_rollout_follows_per_segment_dynamics():
    """The batched rollout's states satisfy each segment's own model."""
    N, h = 20, 0.1
    cp, xf = _hybrid_problem(N)
    params, Zb, _, _ = _batch(cp, N, h)
    fast = ALSolverBatched(cp, SolverOptions())
    Zr = jax.jit(fast.rollout)(params, Zb)
    X, U = np.asarray(Zr.X), np.asarray(Zr.U)
    for fj, fam in enumerate(cp.dynamics_families):
        fp = cp.params.dynamics[fj]
        for k in fam.knots[:3]:
            for b in (0, B - 1):
                xn = fam.fn(fp, X[k, :, b], U[k, :, b], float(Zr.t[k]), float(Zr.h[k]))
                np.testing.assert_allclose(X[k + 1, :, b], np.asarray(xn), atol=1e-10)


def test_stacked_dynamics_params_batched():
    """ONE model fn with per-knot params (stacked family, shared=False):
    a time-varying damping schedule."""
    N, h = 16, 0.1

    def damped_fn(params, x, u, t):
        return jnp.concatenate([x[1:2], x[2:3] - params["c"] * x[1:2], u])

    base = discretize(
        ContinuousModel(params={"c": jnp.asarray(0.2)}, fn=damped_fn, n=3, m=1),
        "rk4",
    )
    prob = Problem(N)
    for k in range(N):
        mk = dataclasses.replace(base, params={"c": jnp.asarray(0.2 + 0.05 * k)})
        prob.set_dynamics(mk, k)
    xf = jnp.array([1.0, 0.0, 0.0])
    prob.set_cost(lqr_cost(jnp.eye(3), jnp.eye(1) * 0.01, xf), range(N))
    prob.set_cost(
        lqr_cost(jnp.eye(3) * 1e4, jnp.zeros((1, 1)), xf, terminal=True), N
    )
    prob.set_constraint(goal_constraint(xf), N)
    prob.set_initial_state(jnp.array([-1.0, 0.0, 0.0]))
    cp = prob.compile()
    assert len(cp.dynamics_families) == 1
    assert not cp.dynamics_families[0].shared

    params, Zb, x0s, Z0 = _batch(cp, N, h, seed=2)
    fast = ALSolverBatched(cp, SolverOptions())
    res = jax.jit(fast.solve)(params, Zb)
    assert np.all(np.asarray(res["status"]) == int(SolverStatus.SOLVED))

    oracle = ALSolver(cp, SolverOptions())
    for b in range(2):
        ob = oracle.solve(cp.params.replace(x0=x0s[:, b]), Z0)
        np.testing.assert_allclose(
            np.asarray(res["Z"].U[..., b]), np.asarray(ob.Z.U),
            rtol=1e-6, atol=1e-8,
        )


def test_per_instance_stacked_dynamics_params_batched():
    """Stacked per-knot dynamics params that ALSO vary per instance
    (leaf [nk] -> [nk, B]): each instance gets its own damping schedule."""
    N, h = 12, 0.1

    def damped_fn(params, x, u, t):
        return jnp.concatenate([x[1:2], x[2:3] - params["c"] * x[1:2], u])

    base = discretize(
        ContinuousModel(params={"c": jnp.asarray(0.2)}, fn=damped_fn, n=3, m=1),
        "rk4",
    )
    prob = Problem(N)
    for k in range(N):
        mk = dataclasses.replace(base, params={"c": jnp.asarray(0.2 + 0.05 * k)})
        prob.set_dynamics(mk, k)
    xf = jnp.array([1.0, 0.0, 0.0])
    prob.set_cost(lqr_cost(jnp.eye(3), jnp.eye(1) * 0.01, xf), range(N))
    prob.set_cost(
        lqr_cost(jnp.eye(3) * 1e4, jnp.zeros((1, 1)), xf, terminal=True), N
    )
    prob.set_constraint(goal_constraint(xf), N)
    prob.set_initial_state(jnp.array([-1.0, 0.0, 0.0]))
    cp = prob.compile()

    rng = np.random.default_rng(5)
    c_sched = jnp.asarray(
        np.asarray(cp.params.dynamics[0]["c"])[:, None]
        * rng.uniform(0.8, 1.2, (N, B))
    )
    params, Zb, x0s, Z0 = _batch(cp, N, h, seed=3)
    params = params.replace(dynamics=({"c": c_sched},))
    fast = ALSolverBatched(cp, SolverOptions())
    res = jax.jit(fast.solve)(params, Zb)
    assert np.all(np.asarray(res["status"]) == int(SolverStatus.SOLVED))

    oracle = ALSolver(cp, SolverOptions())
    for b in range(2):
        pb = cp.params.replace(
            x0=x0s[:, b], dynamics=({"c": c_sched[:, b]},)
        )
        ob = oracle.solve(pb, Z0)
        np.testing.assert_allclose(
            np.asarray(res["Z"].U[..., b]), np.asarray(ob.Z.U),
            rtol=1e-6, atol=1e-8,
        )
