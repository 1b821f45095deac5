"""Multi-device tests on the virtual 8-CPU mesh.

The multi-device story (SURVEY §2.7): scenario batch sharded
over a mesh with psum/pmax statistic collectives, and the associative-scan
Riccati sharded over the horizon axis for long problems.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from altro_jax import ALSolver, ILQRSolver, ProblemParams, SolverOptions, SolverStatus
from altro_jax.models.problems import UnicycleProblem
from altro_jax.parallel.mesh import ShardedALSolver, make_mesh
from altro_jax.solver import pscan, riccati


@pytest.fixture(scope="module")
def mesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    return make_mesh(jax.devices()[:8])


def test_sharded_batch_solve_matches_single_device(mesh8):
    defn = UnicycleProblem()
    defn.N = 20
    defn.__post_init__()
    prob = defn.make_problem(add_constraints=True).compile()
    opts = SolverOptions()
    B = 16
    rng = np.random.default_rng(0)
    x0s = jnp.asarray(rng.uniform(-0.1, 0.1, (B, 3)))
    Z0 = defn.initial_trajectory()
    Zb = jax.tree_util.tree_map(
        lambda l: jnp.broadcast_to(l, (B,) + l.shape), Z0
    )

    # single-device reference
    ref = ALSolver(prob, opts)
    axes = ProblemParams(x0=0, dynamics=None, costs=None, constraints=None)
    res_ref = jax.vmap(ref.solve, in_axes=(axes, 0, None))(
        prob.params.replace(x0=x0s), Zb, None
    )

    # sharded over the mesh
    solver = ShardedALSolver(prob, mesh8, opts)
    params_b = prob.params.replace(x0=solver.shard_batch(x0s))
    res, viol_max, n_solved, n_stalled = solver.solve(params_b, solver.shard_batch(Zb))

    np.testing.assert_array_equal(np.asarray(res.status), np.asarray(res_ref.status))
    np.testing.assert_allclose(res.Z.U, res_ref.Z.U, rtol=1e-8, atol=1e-10)
    assert int(n_solved) == int(
        np.sum(np.asarray(res_ref.status) == int(SolverStatus.SOLVED))
    )
    assert int(n_stalled) == int(
        np.sum(np.asarray(res_ref.status) == int(SolverStatus.SOLVED_STALLED))
    )
    np.testing.assert_allclose(
        float(viol_max), float(np.max(np.asarray(res_ref.stats.violations))), rtol=1e-9
    )


def test_horizon_sharded_pscan(mesh8):
    """Associative-scan Riccati with the expansions sharded over the horizon
    axis: XLA inserts the collectives; results match the sequential pass
    (the north-star 'Riccati scan sharded over the horizon')."""
    defn = UnicycleProblem()
    defn.N = 64  # divisible over 8 devices
    defn.__post_init__()
    prob = defn.make_problem(add_constraints=False).compile()
    solver = ILQRSolver(prob, SolverOptions())
    Z = solver.rollout(prob.params, defn.initial_trajectory())
    exp = solver.expansions(prob.params, (), Z)

    def shard_time(x):
        # shard the [N]-length time axis; the [N+1] stacked arrays keep their
        # terminal row replicated-compatible by staying unsharded
        if x.shape[0] % 8 != 0:
            return x
        return jax.device_put(
            x, NamedSharding(mesh8, P(*(["batch"] + [None] * (x.ndim - 1))))
        )

    exp_sharded = jax.tree_util.tree_map(shard_time, exp)
    z = jnp.zeros(())
    bp_seq = riccati.backward_pass(exp, z, z, solver.opts)
    bp_par = jax.jit(
        lambda e: pscan.backward_pass_pscan(e, z, z, solver.opts)
    )(exp_sharded)
    np.testing.assert_allclose(bp_par.K, bp_seq.K, atol=1e-9)
    np.testing.assert_allclose(bp_par.d, bp_seq.d, atol=1e-9)
    np.testing.assert_allclose(bp_par.P, bp_seq.P, atol=1e-7)
