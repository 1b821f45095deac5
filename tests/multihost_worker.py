"""Worker for the emulated multi-host test (run by tests/test_multihost.py).

Two processes, each with 4 virtual CPU devices, form one 8-device global mesh
via `jax.distributed.initialize` — the same code path a real multi-host
cluster uses (`parallel/mesh.py:init_distributed`).
Each process builds its local shards of a 16-instance problem batch, runs
`ShardedALSolver.solve`, and checks its addressable result shards against a
locally computed single-process reference.
"""
import os
import sys

pid = int(sys.argv[1])
port = sys.argv[2]
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=4"
)
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from altro_jax.parallel.mesh import init_distributed  # noqa: E402

mesh = init_distributed(
    coordinator_address=f"localhost:{port}", num_processes=2, process_id=pid
)
assert jax.device_count() == 8, jax.device_count()
assert jax.local_device_count() == 4, jax.local_device_count()

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from altro_jax import ALSolver, ProblemParams, SolverOptions  # noqa: E402
from altro_jax.models.problems import TripleIntegratorProblem  # noqa: E402
from altro_jax.parallel.mesh import ShardedALSolver  # noqa: E402

B = 16
defn = TripleIntegratorProblem(dof=2)
prob = defn.make_problem(add_constraints=True).compile()
opts = SolverOptions()
rng = np.random.default_rng(0)
x0s = np.asarray(defn.x0)[None, :] + rng.uniform(-0.4, 0.4, (B, defn.n))
Z0 = defn.initial_trajectory()
Zb_np = jax.tree_util.tree_map(
    lambda leaf: np.broadcast_to(np.asarray(leaf), (B,) + leaf.shape), Z0
)

solver = ShardedALSolver(prob, mesh, opts)
sh = solver.batch_sharding


def gmake(np_arr):
    """Global array from the full host copy: each process materializes only
    its addressable shards."""
    return jax.make_array_from_callback(
        np_arr.shape, sh, lambda idx: jnp.asarray(np_arr[idx])
    )


params = prob.params.replace(x0=gmake(x0s))
Zb = jax.tree_util.tree_map(gmake, Zb_np)

res, viol_max, num_solved, num_stalled = solver.solve(params, Zb)
num_solved = int(num_solved)
viol_max = float(viol_max)
assert num_solved == B, f"solved {num_solved}/{B}"
assert viol_max < opts.constraint_tolerance, viol_max

# per-shard parity vs a single-process reference computed locally
ref = jax.vmap(
    ALSolver(prob, opts).solve,
    in_axes=(ProblemParams(x0=0, dynamics=None, costs=None, constraints=None), 0, None),
)(
    prob.params.replace(x0=jnp.asarray(x0s)),
    jax.tree_util.tree_map(jnp.asarray, Zb_np),
    None,
)
U_ref = np.asarray(ref.Z.U)
checked = 0
for shard in res.Z.U.addressable_shards:
    np.testing.assert_allclose(
        np.asarray(shard.data), U_ref[shard.index], rtol=1e-8, atol=1e-10
    )
    checked += shard.data.shape[0]
assert checked == B // 2, checked  # each process owns half the batch

print(f"proc {pid}: MULTIHOST OK ({checked} local instances verified)", flush=True)
