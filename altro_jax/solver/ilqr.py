"""Inner iLQR solver: expansions → backward pass → line-searched forward pass.

The functional, jittable analog of `ilqr::iLQR<n,m>` (`altro/ilqr/ilqr.hpp:47-813`).
All data-dependent control flow (line search, convergence, regularization
retries) is expressed with `lax.while_loop` so the entire solve traces into a
single XLA program and can be vmapped over problem batches — JAX's while-loop
batching masks converged batch elements automatically, replacing the
reference's one-solve-at-a-time loop.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .._pytree import pytree_dataclass, tree_select
from ..options import SolverOptions
from ..problem.problem import CompiledProblem, ProblemParams
from ..types import (
    SolverStats,
    SolverStatus,
    Trajectory,
    stats_init,
    stats_log,
    stats_new_iteration,
)
from .functions import ALState, ProblemFunctions
from .riccati import (
    BackwardPassResult,
    backward_pass,
    decrease_regularization,
    increase_regularization,
)
from . import pscan


@pytree_dataclass
class ForwardPassResult:
    Z: Trajectory
    J: jax.Array
    alpha: jax.Array
    z: jax.Array
    success: jax.Array
    rho: jax.Array
    drho: jax.Array
    status: jax.Array


@pytree_dataclass
class ILQRResult:
    Z: Trajectory
    costs: jax.Array  # [N+1] final per-knot costs
    K: jax.Array  # [N, m, n] final feedback gains
    d: jax.Array  # [N, m] final feedforward gains
    status: jax.Array
    stats: SolverStats


class ILQRSolver:
    """iLQR over a compiled problem, optionally with an AL cost.

    Methods are pure: `(params, al, Z, ...) -> result`.  Pass `al=()` for
    unconstrained problems.  The augmented-Lagrangian outer loop in
    :mod:`altro_jax.solver.al` drives this solver exactly like
    `AugmentedLagrangianiLQR` drives its inner `iLQR` (`al_solver.hpp:313-333`).
    """

    def __init__(self, prob: CompiledProblem, opts: SolverOptions = None):
        self.prob = prob
        self.opts = opts or SolverOptions()
        self.fns = ProblemFunctions(prob, self.opts)
        if self.opts.matmul_precision:
            from .._pytree import with_matmul_precision

            wrap = with_matmul_precision(self.opts.matmul_precision)
            for name in (
                "solve",
                "expansions",
                "backward_pass",
                "forward_pass",
                "closed_loop_rollout",
                "rollout",
            ):
                setattr(self, name, wrap(getattr(self, name)))

    # ------------------------------------------------------------- components
    def rollout(self, params: ProblemParams, Z: Trajectory) -> Trajectory:
        return self.fns.rollout(params, Z)

    def expansions(self, params, al, Z):
        return self.fns.expand(params, al, Z)

    def backward_pass(self, exp, rho=0.0, drho=0.0) -> BackwardPassResult:
        rho = jnp.asarray(rho, exp.A.dtype)
        drho = jnp.asarray(drho, exp.A.dtype)
        if self.opts.backward_pass == "pscan":
            raise ValueError(
                "backward_pass='pscan' was retired in r5 (measured slower "
                "than the sequential sweep everywhere and f32-divergent at "
                "long horizons - PARITY.md); call "
                "solver.pscan.backward_pass_pscan directly for research use"
            )
        return backward_pass(exp, rho, drho, self.opts)

    def closed_loop_rollout(self, params, Z: Trajectory, K, d, alpha):
        """Feedback rollout ū = u + K(x̄−x) + αd with state/control bound
        guards (`ilqr.hpp:468-499`)."""
        opts = self.opts
        prob = self.prob
        x0 = jnp.asarray(params.x0, Z.X.dtype)
        unsolved = jnp.int32(SolverStatus.UNSOLVED)

        def step(carry, inp):
            xbar, valid, status = carry
            k, x_k, u_k, K_k, d_k, t_k, h_k = inp
            ubar = u_k + K_k @ (xbar - x_k) + alpha * d_k
            xnext = prob.dynamics_step(params.dynamics, k, xbar, ubar, t_k, h_k)
            if opts.check_forwardpass_bounds:
                state_ok = jnp.linalg.norm(xnext) <= opts.state_max
                ctrl_ok = jnp.linalg.norm(ubar) <= opts.control_max
            else:
                state_ok = jnp.ones((), bool)
                ctrl_ok = jnp.ones((), bool)
            step_ok = state_ok & ctrl_ok
            fail_now = valid & ~step_ok
            status = jnp.where(
                fail_now,
                jnp.where(
                    ~state_ok,
                    jnp.int32(SolverStatus.STATE_LIMIT),
                    jnp.int32(SolverStatus.CONTROL_LIMIT),
                ),
                status,
            )
            new_valid = valid & step_ok
            xkeep = jnp.where(new_valid, xnext, xbar)
            return (xkeep, new_valid, status), (xkeep, ubar)

        ks = jnp.arange(prob.N)
        init = (x0, jnp.ones((), bool), unsolved)
        (xf, valid, status), (Xnext, Ubar) = jax.lax.scan(
            step, init, (ks, Z.X[:-1], Z.U, K, d, Z.t[:-1], Z.h)
        )
        status = jnp.where(valid, unsolved, status)
        Xbar = jnp.concatenate([x0[None], Xnext], axis=0)
        return Z.replace(X=Xbar, U=Ubar), valid, status

    def forward_pass(
        self, params, al, Z: Trajectory, bp: BackwardPassResult, J0,
        rho=None, drho=None,
    ) -> ForwardPassResult:
        """Backtracking line search with the z-ratio acceptance rule
        (`ilqr.hpp:512-558`).

        `rho`/`drho` are the regularization AFTER the backward pass's
        end-of-pass decrease (`ilqr.hpp:443-444`); a failed line search
        increases from there (`ilqr.hpp:550`).  They default to the
        backward-pass values for standalone use.
        """
        opts = self.opts
        dt = Z.X.dtype
        J0 = jnp.asarray(J0, dt)
        rho = bp.rho if rho is None else rho
        drho = bp.drho if drho is None else drho

        def cond(c):
            it, alpha, success, Zbar, J, z, status = c
            return (~success) & (it < opts.line_search_max_iterations)

        def body(c):
            it, alpha, success, Zbar_prev, J_prev, z_prev, status = c
            Zbar, valid, status = self.closed_loop_rollout(params, Z, bp.K, bp.d, alpha)
            J_try = self.fns.total_cost(params, al, Zbar)
            # only a valid rollout updates J (`ilqr.hpp:526-527`)
            J = jnp.where(valid, J_try, J_prev)
            expected = -alpha * (bp.dV1 + alpha * bp.dV2)
            z = jnp.where(expected > 0.0, (J0 - J_try) / expected, jnp.asarray(-1.0, dt))
            ok = (
                valid
                & (opts.line_search_lower_bound <= z)
                & (z <= opts.line_search_upper_bound)
                & (J_try < J0)
            )
            alpha_next = jnp.where(ok, alpha, alpha / opts.line_search_decrease_factor)
            return (it + 1, alpha_next, ok, Zbar, J, z, status)

        init = (
            jnp.zeros((), jnp.int32),
            jnp.ones((), dt),
            jnp.zeros((), bool),
            Z,
            J0,
            -jnp.ones((), dt),
            jnp.int32(SolverStatus.UNSOLVED),
        )
        it, alpha, success, Zbar, J, z, status = jax.lax.while_loop(cond, body, init)

        Z_out = tree_select(success, Zbar, Z)
        rho, drho = jax.lax.cond(
            success,
            lambda rd: rd,
            lambda rd: increase_regularization(rd[0], rd[1], opts),
            (rho, drho),
        )
        J_final = jnp.where(success, J, J0)
        # Faithful to the reference: this branch is unreachable in exact
        # arithmetic (failure sets J=J0), kept for structural parity
        # (`ilqr.hpp:554-557` has the same dead guard).
        status = jnp.where(
            J_final > J0, jnp.int32(SolverStatus.COST_INCREASE), status
        )
        return ForwardPassResult(
            Z=Z_out, J=J_final, alpha=alpha, z=z, success=success,
            rho=rho, drho=drho, status=status,
        )

    def normalized_feedforward_gain(self, d, U):
        """Gradient proxy: mean over k of max_j |d_j|/(|u_j|+1)
        (`ilqr.hpp:662-668`)."""
        g = jnp.max(jnp.abs(d) / (jnp.abs(U) + 1.0), axis=-1)
        return g.mean()

    # ------------------------------------------------------------------ solve
    def solve(
        self,
        params: ProblemParams,
        al: ALState,
        Z: Trajectory,
        stats: SolverStats = None,
    ) -> ILQRResult:
        """Full inner solve (`iLQR::Solve`, `ilqr.hpp:284-316`).

        Rollout → iterate {expand, backward, forward, stats} until converged.
        `stats` carries across AL outer iterations (iterations_total).
        """
        opts = self.opts
        if stats is None:
            stats = stats_init(opts.stats_capacity, Z.X.dtype)
        prob = self.prob
        N, n, m = prob.N, prob.n, prob.m
        dt = Z.X.dtype

        Z = self.fns.rollout(params, Z)
        J_init = self.fns.total_cost(params, al, Z)
        stats = stats.replace(
            initial_cost=J_init, iterations_inner=jnp.zeros((), jnp.int32)
        )
        rho = jnp.asarray(opts.bp_reg_initial, dt)
        drho = jnp.zeros((), dt)

        def cond(c):
            done = c["done"]
            return ~done

        def body(c):
            Z, rho, drho = c["Z"], c["rho"], c["drho"]
            stats: SolverStats = c["stats"]
            cost_last = c["cost_last"]

            exp = self.fns.expand(params, al, Z)
            J0 = exp.costs.sum()
            bp = self.backward_pass(exp, rho, drho)
            stats = stats_log(stats, regularization=bp.rho)
            # end-of-backward-pass decrease (`ilqr.hpp:443-444`); a failed
            # line search re-increases from the decreased value
            rho_d, drho_d = decrease_regularization(bp.rho, bp.drho, opts)

            fp = self.forward_pass(params, al, Z, bp, J0, rho_d, drho_d)
            status = jnp.where(bp.failed, bp.status, fp.status)

            # statistics (`ilqr.hpp:568-587`): cost/alpha/z logged only on a
            # successful line search (`ilqr.hpp:535-541`)
            cost_new = jnp.where(fp.success, fp.J, cost_last)
            stats = tree_select(
                fp.success,
                stats_log(
                    stats,
                    cost=fp.J,
                    alpha=fp.alpha,
                    improvement_ratio=fp.z,
                ),
                stats,
            )
            grad = self.normalized_feedforward_gain(bp.d, fp.Z.U)
            dJ = cost_last - cost_new
            inner = stats.iterations_inner + 1
            total = stats.iterations_total + 1
            stats = stats_log(stats, cost_decrease=dJ, gradient=grad)
            stats = stats.replace(iterations_inner=inner, iterations_total=total)
            stats = stats_new_iteration(stats)

            # IsDone (`ilqr.hpp:597-619`) — order matters: convergence wins
            # over failure statuses.
            small_dj = dJ < opts.cost_tolerance
            converged = small_dj & (grad < opts.gradient_tolerance)
            # numerical-floor stall exit (see SolverOptions.max_stall_iterations):
            # terminates with its own status so it can't masquerade as SOLVED
            stall = jnp.where(small_dj, c["stall"] + 1, 0)
            if opts.max_stall_iterations > 0:
                stalled = (stall >= opts.max_stall_iterations) & ~converged
            else:
                stalled = jnp.zeros((), bool)
            hit_inner = inner >= opts.max_iterations_inner
            hit_total = total >= opts.max_iterations_total
            bad = status != jnp.int32(SolverStatus.UNSOLVED)
            status = jnp.where(
                converged,
                jnp.int32(SolverStatus.SOLVED),
                jnp.where(
                    stalled,
                    jnp.int32(SolverStatus.SOLVED_STALLED),
                    jnp.where(
                        hit_inner,
                        jnp.int32(SolverStatus.MAX_INNER_ITERATIONS),
                        jnp.where(
                            hit_total, jnp.int32(SolverStatus.MAX_ITERATIONS), status
                        ),
                    ),
                ),
            )
            done = converged | stalled | hit_inner | hit_total | bad
            return {
                "Z": fp.Z,
                "rho": fp.rho,
                "drho": fp.drho,
                "stats": stats,
                "cost_last": cost_new,
                "status": status,
                "done": done,
                "stall": stall,
                "K": bp.K,
                "d": bp.d,
                "costs": exp.costs,
            }

        init = {
            "Z": Z,
            "rho": rho,
            "drho": drho,
            "stats": stats,
            "cost_last": J_init,
            "status": jnp.int32(SolverStatus.UNSOLVED),
            "done": jnp.zeros((), bool),
            "stall": jnp.zeros((), jnp.int32),
            "K": jnp.zeros((N, m, n), dt),
            "d": jnp.zeros((N, m), dt),
            "costs": jnp.zeros((N + 1,), dt),
        }
        out = jax.lax.while_loop(cond, body, init)
        return ILQRResult(
            Z=out["Z"],
            costs=out["costs"],
            K=out["K"],
            d=out["d"],
            status=out["status"],
            stats=out["stats"],
        )
