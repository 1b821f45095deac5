"""Lane-major sharded batched solver (`ShardedBatchedALSolver`, r4).

The production multi-chip path: each device runs the full batch-native
solver on its local shard of the batch-LAST axis under `shard_map`; the
only collectives are the reference's scalar statistics folds
(`al_solver.hpp:417-434`).  In f64 the sharded solve is BITWISE equal to
the unsharded lane-major solve; in f32, compiling at a different local
width moves borderline endpoints within the stopping ball (the PARITY.md
phenomenon), so the f32 contract is statuses + tolerance-ball endpoints.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from altro_jax import SolverOptions, SolverStatus
from altro_jax.models.problems import UnicycleProblem
from altro_jax.parallel.mesh import ShardedBatchedALSolver, make_mesh
from altro_jax.solver.batched import ALSolverBatched, to_batch_last

B = 64


def _setup(dtype):
    defn = UnicycleProblem(dtype=dtype)
    defn.N = 20
    defn.__post_init__()
    prob = defn.make_problem(add_constraints=True).compile()
    rng = np.random.default_rng(0)
    x0s = jnp.asarray(rng.uniform(-0.1, 0.1, (3, B)), dtype)
    params = prob.params.replace(x0=x0s)
    Z0 = defn.initial_trajectory()
    Zb = to_batch_last(
        jax.tree_util.tree_map(
            lambda l: jnp.broadcast_to(l, (B,) + l.shape), Z0
        )
    )
    return prob, params, Zb


def test_sharded_lane_major_bitwise_f64():
    prob, params, Zb = _setup(jnp.float64)
    mesh = make_mesh(jax.devices())
    s = ShardedBatchedALSolver(prob, mesh, SolverOptions())
    res, viol, nsolved, nstalled = s.solve(
        s.shard_params(params), s.shard_batch(Zb)
    )
    ref = jax.jit(ALSolverBatched(prob, SolverOptions()).solve)(params, Zb)
    np.testing.assert_array_equal(
        np.asarray(res["status"]), np.asarray(ref["status"])
    )
    np.testing.assert_allclose(
        np.asarray(res["Z"].U), np.asarray(ref["Z"].U), rtol=0, atol=0
    )
    assert int(nsolved) == int(
        np.sum(np.asarray(ref["status"]) == int(SolverStatus.SOLVED))
    )
    assert float(viol) == float(np.asarray(ref["stats"].violations).max())


def test_sharded_lane_major_f32_statuses_and_ball():
    prob, params, Zb = _setup(jnp.float32)
    mesh = make_mesh(jax.devices())
    s = ShardedBatchedALSolver(prob, mesh, SolverOptions())
    res, viol, nsolved, nstalled = s.solve(
        s.shard_params(params), s.shard_batch(Zb)
    )
    ref = jax.jit(ALSolverBatched(prob, SolverOptions()).solve)(params, Zb)
    np.testing.assert_array_equal(
        np.asarray(res["status"]), np.asarray(ref["status"])
    )
    # endpoints within the f32 stopping ball (PARITY.md)
    np.testing.assert_allclose(
        np.asarray(res["Z"].U), np.asarray(ref["Z"].U), atol=5e-3
    )
    assert int(nsolved) == B
    # replicated leaves come back UNconcatenated (r5 fix: out_specs P()
    # for leaves without a trailing batch axis) — the result honours the
    # `ALSolverBatched.solve` contract so res['Z'] is warm-start reusable
    N = prob.N
    assert res["Z"].t.shape == (N + 1,)
    assert res["Z"].h.shape == (N,)
    np.testing.assert_allclose(np.asarray(res["Z"].t), np.asarray(Zb.t))


def test_sharded_per_instance_params():
    """Per-instance obstacle layouts shard with the batch (each device gets
    its shard's layouts; shared cost params replicate)."""
    defn = UnicycleProblem(scenario="three_obstacles", dtype=jnp.float64)
    defn.N = 12
    defn.__post_init__()
    prob = defn.make_problem(add_constraints=True).compile()
    rng = np.random.default_rng(1)
    cx0, cy0, r0 = defn.obstacles
    ci = next(
        i for i, f in enumerate(prob.constraint_families)
        if f.constraint.structure[0] == "circle"
    )
    cons = list(prob.params.constraints)
    cons[ci] = dict(
        cons[ci],
        cx=jnp.asarray(cx0[:, None] + rng.uniform(-0.1, 0.1, (3, B))),
        cy=jnp.asarray(cy0[:, None] + rng.uniform(-0.1, 0.1, (3, B))),
    )
    params = prob.params.replace(
        x0=jnp.asarray(rng.uniform(-0.1, 0.1, (3, B))),
        constraints=tuple(cons),
    )
    Z0 = defn.initial_trajectory()
    Zb = to_batch_last(
        jax.tree_util.tree_map(
            lambda l: jnp.broadcast_to(l, (B,) + l.shape), Z0
        )
    )
    opts = SolverOptions(initial_penalty=10.0)
    mesh = make_mesh(jax.devices())
    s = ShardedBatchedALSolver(prob, mesh, opts)
    res, viol, nsolved, nstalled = s.solve(
        s.shard_params(params), s.shard_batch(Zb)
    )
    ref = jax.jit(ALSolverBatched(prob, opts).solve)(params, Zb)
    np.testing.assert_array_equal(
        np.asarray(res["status"]), np.asarray(ref["status"])
    )
    np.testing.assert_allclose(
        np.asarray(res["Z"].U), np.asarray(ref["Z"].U), rtol=0, atol=0
    )


def test_collective_traffic_is_scalar_folds():
    """The sharded solve's compiled program moves ~NO data between
    devices: its only collectives are the three scalar statistics folds
    the reference performs in shared memory (`al_solver.hpp:417-434`) —
    one max-violation fold and two solved/stalled counts, ≈16 bytes per
    device per SOLVE.  No all-gather / all-to-all / collective-permute of
    solver state may appear (r5: makes the '12 bytes of collectives'
    scaling argument an assertion, not prose)."""
    prob, params, Zb = _setup(jnp.float32)
    mesh = make_mesh(jax.devices())
    s = ShardedBatchedALSolver(prob, mesh, SolverOptions())
    fn = s._build(s.shard_params(params), Zb)
    hlo = fn.lower(params, Zb).compile().as_text()
    assert "all-gather" not in hlo, "unexpected data-moving collective"
    assert "all-to-all" not in hlo, "unexpected data-moving collective"
    assert "collective-permute" not in hlo, "unexpected data-moving collective"
    # every all-reduce operates on scalars (result shapes like f32[] /
    # (s32[], s32[])); sum the result bytes over all all-reduce ops
    import re

    total_bytes = 0
    n_reduce = 0
    for line in hlo.splitlines():
        if " all-reduce(" not in line:
            continue
        lhs = line.split(" all-reduce(")[0]
        shapes = re.findall(r"([a-z]+\d*)\[([\d,]*)\]", lhs)
        assert shapes, line
        for dt, dims in shapes:
            n_elem = 1
            if dims:
                for d in dims.split(","):
                    n_elem *= int(d)
            width = {"f64": 8, "f32": 4, "s32": 4, "u32": 4, "pred": 1}.get(
                dt, 8
            )
            total_bytes += n_elem * width
        n_reduce += 1
    assert n_reduce >= 1, "expected the statistics folds to be present"
    assert total_bytes <= 32, (n_reduce, total_bytes)
