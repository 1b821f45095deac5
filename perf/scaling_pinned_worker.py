"""Worker for perf/benchmark_scaling_pinned.py (core-pinned weak scaling).

Each process pins itself to ONE physical core (`os.sched_setaffinity`) and
hosts ONE virtual CPU device, so the measurement isolates the DISTRIBUTED
cost (Gloo collectives + lockstep skew across processes) from host-core
oversubscription — the confound of 8 virtual devices on 2 physical
cores, which measures core contention, not communication.

argv: pid nprocs port B_local [core]
Prints one line: SCALING pid=<pid> wall_s=<median solve wall> solved=<n>
"""
import os
import sys
import time

pid = int(sys.argv[1])
nprocs = int(sys.argv[2])
port = sys.argv[3]
B_local = int(sys.argv[4])
core = int(sys.argv[5]) if len(sys.argv) > 5 else pid

os.sched_setaffinity(0, {core})
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=1"
)
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from altro_jax import SolverOptions  # noqa: E402
from altro_jax.models.problems import UnicycleProblem  # noqa: E402
from altro_jax.solver.batched import ALSolverBatched, to_batch_last  # noqa: E402

if nprocs > 1:
    from altro_jax.parallel.mesh import ShardedBatchedALSolver, init_distributed

    mesh = init_distributed(
        coordinator_address=f"localhost:{port}",
        num_processes=nprocs,
        process_id=pid,
    )
else:
    mesh = None

B_global = B_local * nprocs
dtype = jnp.float32
defn = UnicycleProblem(dtype=dtype)
defn.N = 20
defn.__post_init__()
prob = defn.make_problem(add_constraints=True).compile()
opts = SolverOptions(max_stall_iterations=3)

rng = np.random.default_rng(0)
# every device solves the IDENTICAL instance set (the local fleet tiled
# across processes) so the weak-scaling comparison is instance-matched:
# per-device work is exactly equal and any wall difference is
# communication + skew, not lockstep-depth luck
x0s_local = rng.uniform(-0.1, 0.1, (3, B_local)).astype(np.float32)
x0s_np = np.tile(x0s_local, (1, nprocs))
Z0 = defn.initial_trajectory()


def local_Zb(B):
    Zb = to_batch_last(
        jax.tree_util.tree_map(
            lambda l: jnp.broadcast_to(l, (B,) + l.shape), Z0
        )
    )
    return jax.tree_util.tree_map(
        lambda l: l.astype(dtype) if l.dtype.kind == "f" else l, Zb
    )


if nprocs == 1:
    solver = ALSolverBatched(prob, opts)
    params = prob.params.replace(x0=jnp.asarray(x0s_local))
    Zb = local_Zb(B_local)
    fn = jax.jit(solver.solve)

    def run():
        res = fn(params, Zb)
        jax.block_until_ready(res["status"])
        return int((np.asarray(res["status"]) == 0).sum())

else:
    from jax.sharding import NamedSharding, PartitionSpec as P

    solver = ShardedBatchedALSolver(prob, mesh, opts)
    sh = NamedSharding(mesh, P("batch"))

    def gmake(np_arr):
        # trailing-axis batch shard: transpose spec for [3, B]
        shd = NamedSharding(mesh, P(*([None] * (np_arr.ndim - 1) + ["batch"])))
        return jax.make_array_from_callback(
            np_arr.shape, shd, lambda idx: jnp.asarray(np_arr[idx])
        )

    params = prob.params.replace(x0=gmake(x0s_np))
    Zb_l = local_Zb(B_local)
    Zb = jax.tree_util.tree_map(
        lambda l: (
            jax.make_array_from_single_device_arrays(
                l.shape[:-1] + (B_global,),
                NamedSharding(mesh, P(*([None] * (l.ndim - 1) + ["batch"]))),
                [jax.device_put(l, jax.local_devices()[0])],
            )
            if l.ndim > 1
            else l
        ),
        Zb_l,
    )

    def run():
        res, viol, nsolved, nstalled = solver.solve(params, Zb)
        jax.block_until_ready(nsolved)
        return int(nsolved)


solved = run()  # compile + warm
walls = []
for _ in range(5):
    t0 = time.perf_counter()
    solved = run()
    walls.append(time.perf_counter() - t0)
print(
    f"SCALING pid={pid} wall_s={float(np.median(walls)):.4f} "
    f"solved={solved} walls={[round(w, 4) for w in walls]}",
    flush=True,
)
