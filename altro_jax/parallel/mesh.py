"""Multi-device scaling: sharded batched solves over a device mesh.

The reference has no distributed story; here the batch of scenarios is
sharded over the mesh's ``"batch"`` axis with `jax.sharding`.  Per-scenario
solves are independent, and the only cross-device communication is the
scalar statistics folds the reference also performs — total cost, max
violation, max penalty (`altro/augmented_lagrangian/al_solver.hpp:417-434`,
`ilqr/ilqr.hpp:333`) — which become `psum`/`pmax` collectives inside
`shard_map` (NCCL on GPUs).  The mesh is 1-D: the algorithm has one
parallel axis, and the cards of one host reach each other all to all.

Multi-host: create the mesh over all processes' devices after
`jax.distributed.initialize()`; the solver code is unchanged.
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..options import SolverOptions
from ..problem.problem import CompiledProblem, ProblemParams
from ..solver.al import ALSolver
from ..types import SolverStatus, Trajectory
from .batch import params_axes


def make_mesh(devices: Optional[Sequence] = None, axis: str = "batch") -> Mesh:
    devices = list(devices) if devices is not None else jax.devices()
    return Mesh(np.array(devices), (axis,))


def init_distributed(**kwargs) -> Mesh:
    """Multi-host setup: initialize `jax.distributed` with `kwargs`
    (`coordinator_address`, `num_processes`, `process_id`) and return a
    global mesh over every process's devices; the solver code is unchanged.
    """
    jax.distributed.initialize(**kwargs)
    return make_mesh(jax.devices())


class ShardedALSolver:
    """AL-iLQR over a scenario batch sharded across a device mesh.

    The solve itself is `vmap`ped; sharding annotations place the batch axis
    over the mesh, and a `shard_map`-wrapped reduction computes fleet-wide
    solve statistics (max violation / solved fraction) with explicit
    collectives instead of host transfers.
    """

    def __init__(
        self,
        prob: CompiledProblem,
        mesh: Mesh,
        opts: SolverOptions = None,
        in_axes: ProblemParams = None,
        axis: str = "batch",
    ):
        self.prob = prob
        self.mesh = mesh
        self.axis = axis
        self.solver = ALSolver(prob, opts)
        in_axes = in_axes if in_axes is not None else params_axes(x0=0)
        self.in_axes = in_axes

        vsolve = jax.vmap(self.solver.solve, in_axes=(in_axes, 0, None))

        batch_sharding = NamedSharding(mesh, P(axis))
        self.batch_sharding = batch_sharding
        replicated = NamedSharding(mesh, P())

        def solve_and_reduce(params, Z):
            res = vsolve(params, Z, None)
            # Fleet statistics with explicit mesh collectives.
            from jax import shard_map

            def local_stats(viol, status):
                v = jnp.max(viol)
                solved = jnp.sum(
                    (status == jnp.int32(SolverStatus.SOLVED)).astype(jnp.int32)
                )
                stalled = jnp.sum(
                    (status == jnp.int32(SolverStatus.SOLVED_STALLED)).astype(
                        jnp.int32
                    )
                )
                v = jax.lax.pmax(v, axis)
                solved = jax.lax.psum(solved, axis)
                stalled = jax.lax.psum(stalled, axis)
                return v[None], solved[None], stalled[None]

            viol_max, num_solved, num_stalled = shard_map(
                local_stats,
                mesh=mesh,
                in_specs=(P(axis), P(axis)),
                out_specs=(P(), P(), P()),
            )(res.stats.violations, res.status)
            return res, viol_max[0], num_solved[0], num_stalled[0]

        self._solve = jax.jit(
            solve_and_reduce,
            in_shardings=(
                jax.tree_util.tree_map(
                    lambda ax: batch_sharding if ax == 0 else replicated,
                    in_axes,
                    is_leaf=lambda x: x is None or isinstance(x, int),
                ),
                batch_sharding,
            ),
        )

    def shard_batch(self, tree):
        """Place a batched pytree onto the mesh's batch axis."""
        return jax.device_put(tree, self.batch_sharding)

    def solve(self, params: ProblemParams, Z: Trajectory):
        """Solve the sharded batch.

        Returns ``(results, max_violation, n_solved, n_stalled)`` —
        ``n_solved`` counts `SolverStatus.SOLVED` only; stall exits
        (`SolverStatus.SOLVED_STALLED`) are reported separately so fleet
        statistics can't silently absorb non-convergence.
        """
        return self._solve(params, Z)


class ShardedBatchedALSolver:
    """LANE-MAJOR batched AL-iLQR sharded over a device mesh (the
    production multi-chip path, r4).

    `ShardedALSolver` vmaps the per-instance solver (batch-LEADING layout —
    correct, and the multihost-tested path, but ~500x off the lane-major
    throughput, see `solver/batched.py`).  This class instead runs the full
    batch-native `ALSolverBatched` — Pallas kernels included — on each
    device's local shard of the batch-LAST axis under `shard_map`.  The
    solve is communication-free by construction (per-scenario independence:
    the reference's analog is separate solver objects per thread); the only
    collectives are the scalar statistics folds the reference performs in
    shared memory (`al_solver.hpp:417-434`): one pmax (max violation) and
    two psums (solved / stalled counts) per SOLVE — 12 bytes per device,
    so data-parallel scaling is limited only by load balance
    (lockstep-per-shard, not lockstep-global: each device iterates exactly
    as long as ITS shard needs).
    """

    def __init__(
        self,
        prob: CompiledProblem,
        mesh: Mesh,
        opts: SolverOptions = None,
        axis: str = "batch",
    ):
        from ..solver.batched import ALSolverBatched

        self.prob = prob
        self.mesh = mesh
        self.axis = axis
        self.solver = ALSolverBatched(prob, opts)
        self._cache = {}

    def _spec(self, ndim: int):
        return P(*([None] * (ndim - 1) + [self.axis]))

    def shard_batch(self, tree):
        """Place a batch-LAST trajectory/AL pytree's trailing axis onto the
        mesh (1-D leaves like the shared time grid stay replicated)."""
        return jax.device_put(
            tree,
            jax.tree_util.tree_map(
                lambda l: NamedSharding(
                    self.mesh,
                    self._spec(jnp.ndim(l)) if jnp.ndim(l) > 1 else P(),
                ),
                tree,
            ),
        )

    def shard_params(self, params: ProblemParams):
        """Shard per-instance (trailing-batch) param leaves; replicate
        shared ones (the `batch_axes` convention)."""
        canon = self.prob.params
        return jax.device_put(
            params,
            jax.tree_util.tree_map(
                lambda c, l: NamedSharding(
                    self.mesh,
                    self._spec(jnp.ndim(l))
                    if jnp.ndim(l) == jnp.ndim(c) + 1
                    else P(),
                ),
                canon,
                params,
            ),
        )

    def _build(self, params, Zb):
        from jax import shard_map

        axis = self.axis
        mesh = self.mesh
        nd = int(np.prod(mesh.devices.shape))
        canon = self.prob.params

        def pspec(c, leaf):
            if jnp.ndim(leaf) == jnp.ndim(c) + 1:
                return self._spec(jnp.ndim(leaf))
            return P()

        params_specs = jax.tree_util.tree_map(pspec, canon, params)
        Z_specs = type(Zb)(
            X=self._spec(Zb.X.ndim), U=self._spec(Zb.U.ndim), t=P(), h=P()
        )

        def local_fn(params_l, Z_l):
            res = self.solver.solve(params_l, Z_l)
            viol = jax.lax.pmax(jnp.max(res["stats"].violations), axis)
            solved = jax.lax.psum(
                jnp.sum(
                    (res["status"] == jnp.int32(SolverStatus.SOLVED)).astype(
                        jnp.int32
                    )
                ),
                axis,
            )
            stalled = jax.lax.psum(
                jnp.sum(
                    (
                        res["status"]
                        == jnp.int32(SolverStatus.SOLVED_STALLED)
                    ).astype(jnp.int32)
                ),
                axis,
            )
            return res, viol, solved, stalled

        # result specs from the local result structure (every leaf carries
        # the batch in its trailing axis)
        def localize(leaf):
            shape = list(leaf.shape)
            shape[-1] = shape[-1] // nd
            return jax.ShapeDtypeStruct(tuple(shape), leaf.dtype)

        res_struct = jax.eval_shape(
            self.solver.solve,
            jax.tree_util.tree_map(
                lambda c, l: (
                    localize(jax.ShapeDtypeStruct(jnp.shape(l), jnp.asarray(l).dtype))
                    if jnp.ndim(l) == jnp.ndim(c) + 1
                    else jax.ShapeDtypeStruct(jnp.shape(l), jnp.asarray(l).dtype)
                ),
                canon,
                params,
            ),
            jax.tree_util.tree_map(
                lambda l: (
                    localize(jax.ShapeDtypeStruct(l.shape, l.dtype))
                    if l.ndim > 1
                    else jax.ShapeDtypeStruct(l.shape, l.dtype)
                ),
                Zb,
            ),
        )
        # replicated result leaves (e.g. the shared time grid Z.t / Z.h)
        # must come back with spec P(), not a sharded trailing axis —
        # otherwise shard_map concatenates the per-device copies and e.g.
        # res['Z'].t returns (N+1)*n_devices entries, breaking the
        # `ALSolverBatched.solve` result contract and warm-start reuse.
        # A leaf carries the batch iff its shape changes when the local
        # batch width does, so compare against the full-width structure.
        res_struct_full = jax.eval_shape(
            self.solver.solve,
            jax.tree_util.tree_map(
                lambda l: jax.ShapeDtypeStruct(
                    jnp.shape(l), jnp.asarray(l).dtype
                ),
                params,
            ),
            jax.tree_util.tree_map(
                lambda l: jax.ShapeDtypeStruct(l.shape, l.dtype), Zb
            ),
        )
        res_specs = jax.tree_util.tree_map(
            lambda loc, full: (
                self._spec(len(loc.shape)) if loc.shape != full.shape else P()
            ),
            res_struct,
            res_struct_full,
        )
        fn = shard_map(
            local_fn,
            mesh=mesh,
            in_specs=(params_specs, Z_specs),
            out_specs=(res_specs, P(), P(), P()),
            check_vma=False,
        )
        return jax.jit(fn)

    def solve(self, params: ProblemParams, Zb):
        """Solve the sharded batch-last fleet.

        Returns ``(res dict, max_violation, n_solved, n_stalled)`` with the
        same result contract as `ALSolverBatched.solve`.
        """
        key = (
            jax.tree_util.tree_structure((params, Zb)),
            tuple(jnp.shape(l) for l in jax.tree_util.tree_leaves((params, Zb))),
        )
        if key not in self._cache:
            self._cache[key] = self._build(params, Zb)
        return self._cache[key](params, Zb)
