"""Receding-horizon MPC on top of the AL-iLQR solver.

The reference's MPC story is warm starting: the solution trajectory is
jointly owned with the caller and reused as the next initial guess
(`altro/ilqr/ilqr.hpp:222-235`), and duals/penalties persist across solves
unless reset (`al_solver.hpp:288-302`, `solver_options.hpp:47-48`); its MPC
benchmark re-solves the same problem in a loop
(`perf/benchmark_unicycle.cpp:45-75`).

Here that workflow is explicit state: `MPCState = (Z, al)` threads through
`step()`, and the solve is one jitted function of (x0, warm state) so a
100 Hz loop never retraces.  For fleets use `BatchedMPC` (lane-major
batch-native re-solves); `vmap` over the per-instance `step` also works but
leaves the device mostly idle (batch-first layout, tiny per-knot matrices —
orders of magnitude slower at B=256).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import weakref

import jax
import jax.numpy as jnp

from .._pytree import pytree_dataclass
from ..options import SolverOptions
from ..problem.problem import CompiledProblem, ProblemParams
from ..types import SolverStatus, Trajectory
from .al import ALSolver


@pytree_dataclass
class MPCState:
    Z: Trajectory
    al: tuple
    status: jax.Array
    iterations: jax.Array


class MPC:
    """Warm-started receding-horizon controller.

    Options default to the reference's warm-start configuration: duals are
    kept across re-solves (`reset_duals=False`) and penalties restart at
    `initial_penalty` (matching `al_solver.hpp:288-302` when
    `reset_duals=false`).

    `shift=True` advances the warm-start guess by one knot each step
    (receding horizon); `shift=False` re-solves the same horizon
    (the reference benchmark's behavior).
    """

    def __init__(
        self,
        prob: CompiledProblem,
        opts: SolverOptions = None,
        shift: bool = True,
    ):
        opts = opts or SolverOptions()
        if opts.reset_duals:
            opts = opts.replace(reset_duals=False)
        self.opts = opts
        self.prob = prob
        self.solver = ALSolver(prob, opts)
        self.shift = shift
        self._solve = jax.jit(self.solver.solve)

    def init(self, Z0: Trajectory) -> MPCState:
        al = self.solver.init_al_state(Z0.X.dtype)
        return MPCState(
            Z=Z0,
            al=al,
            status=jnp.int32(int(SolverStatus.UNSOLVED)),
            iterations=jnp.zeros((), jnp.int32),
        )

    def step(self, state: MPCState, x0, params: Optional[ProblemParams] = None):
        """Re-solve from measured state `x0`; returns (u0, new_state).

        `params` optionally overrides other problem data (moving references,
        obstacle updates) — same pytree structure, no recompile.
        """
        params = (params or self.prob.params).replace(x0=jnp.asarray(x0))
        res = self._solve(params, state.Z, state.al)
        u0 = res.Z.U[..., 0, :]
        Zwarm = _shift_trajectory(res.Z) if self.shift else res.Z
        new_state = MPCState(
            Z=Zwarm,
            al=res.al,
            status=res.status,
            iterations=res.stats.iterations_total,
        )
        return u0, new_state

    def rollout_ticks(self, state: MPCState, x0, plant_fn, n_ticks: int):
        """Run `n_ticks` warm-started MPC ticks as ONE on-device program.

        `plant_fn(x, u) -> x_next` is the simulated vehicle closing the
        loop.  Returns `(final_state, x_final, X_hist, U_hist)` where the
        histories have a leading tick axis.  The whole chain is one jitted
        `lax.scan` — one host dispatch total — so wall / n_ticks is the
        amortized DEVICE latency of a control tick, free of per-call
        dispatch RTT.  This is both the measurement path
        (perf/mpc_device_latency.py) and the deployment shape for a
        controller that runs without the host in the loop.
        """
        fn = self._tick_chain(plant_fn, int(n_ticks))
        (st, x), (X, U) = fn(state, jnp.asarray(x0))
        return st, x, X, U

    def _tick_chain(self, plant_fn, n_ticks: int):
        # keyed on the function OBJECT (WeakKeyDictionary), not id():
        # after the original function is garbage-collected a new callable
        # can reuse the same id and would silently get the stale compiled
        # chain with the wrong plant dynamics
        cache = getattr(self, "_chains", None)
        if cache is None:
            cache = self._chains = weakref.WeakKeyDictionary()
        per_fn = cache.get(plant_fn)
        if per_fn is None:
            per_fn = cache[plant_fn] = {}
        cache = per_fn
        key = n_ticks
        if key not in cache:

            def tick(carry, _):
                st, x = carry
                params = self.prob.params.replace(x0=x)
                res = self.solver.solve(params, st.Z, st.al)
                u0 = res.Z.U[..., 0, :]
                Zw = _shift_trajectory(res.Z) if self.shift else res.Z
                st2 = MPCState(
                    Z=Zw, al=res.al, status=res.status,
                    iterations=res.stats.iterations_total,
                )
                xn = plant_fn(x, u0)
                return (st2, xn), (xn, u0)

            cache[key] = jax.jit(
                lambda st, x: jax.lax.scan(tick, (st, x), None, length=n_ticks)
            )
        return cache[key]


def _shift_trajectory(Z: Trajectory) -> Trajectory:
    """Advance the warm-start guess one knot: controls shift left, the last
    control repeats; states shift correspondingly (the solver re-rollouts
    states from x0 anyway, `ilqr.hpp:453-459`)."""
    U = jnp.concatenate([Z.U[..., 1:, :], Z.U[..., -1:, :]], axis=-2)
    X = jnp.concatenate([Z.X[..., 1:, :], Z.X[..., -1:, :]], axis=-2)
    return Z.replace(X=X, U=U)


class BatchedMPC:
    """Warm-started receding-horizon control for a FLEET of vehicles.

    The per-instance `MPC` under `vmap` puts the batch axis first, which
    leaves every per-knot matrix tiny and the device mostly idle (orders
    of magnitude slower than the lane-major batch-native solver at
    B=256).  This class
    runs the fleet through `ALSolverBatched` instead: one jitted lane-major
    solve per control tick, warm-started from each instance's previous
    trajectory and duals — the batched analog of the reference's re-solve
    loop (`perf/benchmark_unicycle.cpp:45-75`).

    States/controls are batch-last: `x0` is `[n, B]`, `step` returns
    `u0 [m, B]`.

    Real-time use: cap the per-tick compute with
    `SolverOptions(max_iterations_total=K)` — the fleet step is lockstep,
    so ONE never-converging instance otherwise runs to the full iteration
    cap every tick and the whole fleet waits (5 unconverged of 4096 made
    ticks 28x slower).  A capped instance
    reports MAX_ITERATIONS that tick and keeps improving across ticks via
    the warm start — standard real-time iLQR practice.  The warm-started
    fleet's p50 is 2 iterations; use K=3 with `rollout_ticks` (ticks
    chained on-device, no per-tick host dispatch) for fleets that must
    meet a 100 Hz deadline (`perf/mpc_device_latency.py` measures it).
    """

    def __init__(
        self,
        prob: CompiledProblem,
        opts: SolverOptions = None,
        shift: bool = True,
    ):
        from .batched import ALSolverBatched

        opts = opts or SolverOptions()
        if opts.reset_duals:
            opts = opts.replace(reset_duals=False)
        self.opts = opts
        self.prob = prob
        self.solver = ALSolverBatched(prob, opts)
        self.shift = shift
        self._solve = jax.jit(self.solver.solve)

    def init(self, Zb) -> MPCState:
        """`Zb`: batch-last initial-guess trajectory (`to_batch_last`)."""
        B = Zb.X.shape[-1]
        al = self.solver.al_state_init(B, Zb.X.dtype)
        return MPCState(
            Z=Zb,
            al=al,
            status=jnp.full((B,), int(SolverStatus.UNSOLVED), jnp.int32),
            iterations=jnp.zeros((B,), jnp.int32),
        )

    def step(self, state: MPCState, x0, params: Optional[ProblemParams] = None):
        """Re-solve the whole fleet from measured states `x0 [n, B]`;
        returns (u0 [m, B], new_state)."""
        params = (params or self.prob.params).replace(x0=jnp.asarray(x0))
        res = self._solve(params, state.Z, state.al)
        Zsol = res["Z"]
        u0 = Zsol.U[0]
        Zwarm = _shift_batch_last(Zsol) if self.shift else Zsol
        new_state = MPCState(
            Z=Zwarm,
            al=res["al"],
            status=res["status"],
            iterations=res["stats"].iterations_total,
        )
        return u0, new_state

    def rollout_ticks(self, state: MPCState, x0, plant_fn, n_ticks: int):
        """Fleet analog of `MPC.rollout_ticks`: `n_ticks` lockstep fleet
        re-solves + plant steps as ONE on-device `lax.scan` (one host
        dispatch; amortized wall / n_ticks = device tick latency).
        `x0` is `[n, B]`; `plant_fn(x [n,B], u [m,B]) -> [n,B]`."""
        fn = self._tick_chain(plant_fn, int(n_ticks))
        (st, x), (X, U) = fn(state, jnp.asarray(x0))
        return st, x, X, U

    def _tick_chain(self, plant_fn, n_ticks: int):
        # keyed on the function OBJECT (WeakKeyDictionary), not id():
        # after the original function is garbage-collected a new callable
        # can reuse the same id and would silently get the stale compiled
        # chain with the wrong plant dynamics
        cache = getattr(self, "_chains", None)
        if cache is None:
            cache = self._chains = weakref.WeakKeyDictionary()
        per_fn = cache.get(plant_fn)
        if per_fn is None:
            per_fn = cache[plant_fn] = {}
        cache = per_fn
        key = n_ticks
        if key not in cache:

            def tick(carry, _):
                st, x = carry
                params = self.prob.params.replace(x0=x)
                res = self.solver.solve(params, st.Z, st.al)
                Zsol = res["Z"]
                u0 = Zsol.U[0]
                Zw = _shift_batch_last(Zsol) if self.shift else Zsol
                st2 = MPCState(
                    Z=Zw, al=res["al"], status=res["status"],
                    iterations=res["stats"].iterations_total,
                )
                xn = plant_fn(x, u0)
                return (st2, xn), (xn, u0)

            cache[key] = jax.jit(
                lambda st, x: jax.lax.scan(tick, (st, x), None, length=n_ticks)
            )
        return cache[key]


def _shift_batch_last(Z):
    """Batch-last (`[N, dim, B]`) analog of `_shift_trajectory` — time is
    the leading axis in the lane-major layout."""
    U = jnp.concatenate([Z.U[1:], Z.U[-1:]], axis=0)
    X = jnp.concatenate([Z.X[1:], Z.X[-1:]], axis=0)
    return Z.replace(X=X, U=U)
