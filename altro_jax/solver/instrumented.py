"""Host-stepped AL-iLQR solve with live logging and phase profiling.

The production solver traces the entire AL-iLQR into one fused XLA while_loop
(`solver/al.py`, `solver/ilqr.py`) — nothing observable happens on the host
until it returns.  The reference, by contrast, prints the iteration table
DURING the solve (`altro/common/solver_logger.cpp:47-54`,
`al_solver.hpp:318-331`) and accumulates a hierarchical phase profile when
`profiler_enable` is set (`al_solver.hpp:307-309`; Stopwatch scopes at
`ilqr/ilqr.hpp:294,351,386,469,513,569,598,630`).

This module is the JAX equivalent: the SAME jitted phase kernels
(rollout, expansions, backward pass, line-searched forward pass) driven by a
host loop that blocks between phases, so each `Timer` scope measures real
device time and each iteration emits a live logger row.  The math and
iteration path are identical to the fused solver (tested); the cost is one
host sync per phase — the analog of the reference's ~10 µs/stopwatch overhead
(`timer.hpp:20-23`).  `ALSolver.solve` routes here automatically on eager
(non-traced) calls when `profiler_enable` or a non-silent `verbose` is set.
"""
from __future__ import annotations

import os

import jax
import jax.numpy as jnp

from ..options import LogLevel, SolverOptions
from ..types import (
    SolverStatus,
    stats_init,
    stats_log,
    stats_new_iteration,
)
from ..utils.logging import SolverLogger
from ..utils.timer import Timer
from .riccati import decrease_regularization


def is_traced(*trees) -> bool:
    """True if any leaf is a tracer (solve running under jit/vmap)."""
    return any(
        isinstance(leaf, jax.core.Tracer)
        for leaf in jax.tree_util.tree_leaves(trees)
    )


class InstrumentedSolve:
    """Host-orchestrated AL-iLQR mirror of `ALSolver.solve`.

    Built lazily by `ALSolver` on first instrumented call; holds jitted phase
    kernels so repeated instrumented solves don't retrace.
    """

    def __init__(self, al_solver):
        self.al = al_solver
        self.opts: SolverOptions = al_solver.opts
        self.prob = al_solver.prob
        self.fns = al_solver.fns
        ilqr = al_solver.ilqr
        # Phase kernels — the same (precision-wrapped) component methods the
        # fused solver traces, jitted individually so each phase is one
        # dispatch the host can block on and time.
        self._rollout = jax.jit(ilqr.rollout)
        self._expand = jax.jit(ilqr.expansions)
        self._bp = jax.jit(lambda exp, rho, drho: ilqr.backward_pass(exp, rho, drho))
        self._fp = jax.jit(
            lambda params, al, Z, bp, J0, rho, drho: ilqr.forward_pass(
                params, al, Z, bp, J0, rho, drho
            )
        )
        self._total_cost = jax.jit(self.fns.total_cost)
        self._cvals = jax.jit(self.fns.constraint_values)
        self._grad = jax.jit(ilqr.normalized_feedforward_gain)
        self.timer = Timer(active=self.opts.profiler_enable)
        self.logger = SolverLogger(
            self.opts.verbose, frequency=self.opts.header_frequency
        )
        self.logger.set_tolerances(
            self.opts.cost_tolerance,
            self.opts.constraint_tolerance,
            self.opts.gradient_tolerance,
        )

    # ------------------------------------------------------------- inner solve
    def _inner_solve(self, params, al, Z, stats, viol_pen):
        """Host mirror of `ILQRSolver.solve` (`ilqr/ilqr.hpp:284-316`)."""
        opts = self.opts
        timer = self.timer
        logger = self.logger
        dt = Z.X.dtype

        with timer.scope("init", block=True):
            Z = self._rollout(params, Z)
            J_init = self._total_cost(params, al, Z)
        stats = stats.replace(
            initial_cost=J_init, iterations_inner=jnp.zeros((), jnp.int32)
        )
        rho = jnp.asarray(opts.bp_reg_initial, dt)
        drho = jnp.zeros((), dt)
        cost_last = J_init
        status = SolverStatus.UNSOLVED
        stall = 0
        K = d = None

        while True:
            with timer.scope("expansions", block=True):
                exp = self._expand(params, al, Z)
            J0 = exp.costs.sum()
            with timer.scope("backward_pass", block=True):
                bp = self._bp(exp, rho, drho)
            stats = stats_log(stats, regularization=bp.rho)
            rho_d, drho_d = decrease_regularization(bp.rho, bp.drho, opts)
            with timer.scope("forward_pass", block=True):
                fp = self._fp(params, al, Z, bp, J0, rho_d, drho_d)

            with timer.scope("stats"):
                bp_failed = bool(bp.failed)
                success = bool(fp.success)
                status_code = int(bp.status if bp_failed else fp.status)
                cost_new = fp.J if success else cost_last
                if success:
                    stats = stats_log(
                        stats, cost=fp.J, alpha=fp.alpha, improvement_ratio=fp.z
                    )
                grad = self._grad(bp.d, fp.Z.U)
                dJ = float(cost_last - cost_new)
                stats = stats_log(stats, cost_decrease=dJ, gradient=grad)
                stats = stats.replace(
                    iterations_inner=stats.iterations_inner + 1,
                    iterations_total=stats.iterations_total + 1,
                )
                stats = stats_new_iteration(stats)

            if logger.level >= LogLevel.INNER:
                logger.log("iters", int(stats.iterations_total))
                logger.log("iter_al", int(stats.iterations_outer))
                logger.log("cost", float(cost_new))
                logger.log("dJ", dJ)
                logger.log("grad", float(grad))
                if success:
                    logger.log("alpha", float(fp.alpha))
                    logger.log("z", float(fp.z))
                logger.log("reg", float(bp.rho))
                logger.log("viol", viol_pen[0])
                logger.log("pen", viol_pen[1])
                logger.print_row()

            with timer.scope("convergence_check"):
                inner = int(stats.iterations_inner)
                total = int(stats.iterations_total)
                grad_f = float(grad)
                small_dj = dJ < opts.cost_tolerance
                converged = small_dj and grad_f < opts.gradient_tolerance
                stall = stall + 1 if small_dj else 0
                stalled = (
                    opts.max_stall_iterations > 0
                    and stall >= opts.max_stall_iterations
                    and not converged
                )
                bad = status_code != SolverStatus.UNSOLVED
                if converged:
                    status = SolverStatus.SOLVED
                elif stalled:
                    status = SolverStatus.SOLVED_STALLED
                elif inner >= opts.max_iterations_inner:
                    status = SolverStatus.MAX_INNER_ITERATIONS
                elif total >= opts.max_iterations_total:
                    status = SolverStatus.MAX_ITERATIONS
                else:
                    status = SolverStatus(status_code)
                done = converged or stalled or bad or (
                    inner >= opts.max_iterations_inner
                    or total >= opts.max_iterations_total
                )

            Z, rho, drho = fp.Z, fp.rho, fp.drho
            cost_last = cost_new
            K, d = bp.K, bp.d
            if done:
                break
        return dict(Z=Z, K=K, d=d, status=status, stats=stats)

    # --------------------------------------------------------------- solve
    def solve(self, params, Z, al=None):
        from .al import ALResult

        opts = self.opts
        fns = self.fns
        timer = self.timer
        logger = self.logger
        timer.reset()
        logger.reset()
        dt = Z.X.dtype
        N, n, m = self.prob.N, self.prob.n, self.prob.m

        with timer.scope("al"):
            with timer.scope("init", block=True):
                if al is None:
                    al = fns.al_state_init(dt)
                if opts.reset_duals:
                    al = fns.reset_duals(al)
                if opts.initial_penalty > 0:
                    al = fns.set_penalty(al, opts.initial_penalty)
                stats = stats_init(opts.stats_capacity, dt)
                cvals0 = fns.constraint_values(params, Z)
                viol = (
                    float(fns.max_violation(cvals0))
                    if cvals0
                    else 0.0
                )
                pen = float(fns.max_penalty(al)) if al else 0.0
                stats = stats_log(stats, violations=viol, max_penalty=pen)

            if not self.prob.constraint_families:
                with timer.scope("ilqr"):
                    res = self._inner_solve(params, (), Z, stats, (viol, pen))
                result = ALResult(
                    Z=res["Z"], al=(), status=jnp.int32(res["status"]),
                    stats=res["stats"], K=res["K"], d=res["d"],
                )
                self._finish(res["status"])
                return result

            status = SolverStatus.UNSOLVED
            out = None
            while True:
                with timer.scope("ilqr"):
                    res = self._inner_solve(params, al, Z, stats, (viol, pen))
                Z, stats = res["Z"], res["stats"]

                with timer.scope("dual_update", block=True):
                    cvals = self._cvals(params, Z)
                    al_new = fns.update_duals(al, cvals)
                    viol = float(fns.max_violation(cvals))
                    pen = float(fns.max_penalty(al_new))
                outer = int(stats.iterations_outer) + 1
                stats = stats.replace(iterations_outer=jnp.int32(outer))
                stats = stats_log(stats, violations=viol, max_penalty=pen)

                if logger.level >= LogLevel.OUTER:
                    logger.log("iters", int(stats.iterations_total))
                    logger.log("iter_al", outer)
                    logger.log("cost", float(stats.cost))
                    logger.log("viol", viol)
                    logger.log("pen", pen)
                    logger.print_row()

                with timer.scope("convergence_check"):
                    inner_solved = res["status"] == SolverStatus.SOLVED
                    inner_ok = inner_solved or (
                        res["status"] == SolverStatus.SOLVED_STALLED
                    )
                    sat = viol < opts.constraint_tolerance
                    pen_hi = pen > opts.maximum_penalty
                    outer_hi = outer >= opts.max_iterations_outer
                    total_hi = (
                        int(stats.iterations_total) >= opts.max_iterations_total
                    )
                    if not inner_ok:
                        status = res["status"]
                    elif sat:
                        status = (
                            SolverStatus.SOLVED
                            if inner_solved
                            else SolverStatus.SOLVED_STALLED
                        )
                    elif pen_hi:
                        status = SolverStatus.MAX_PENALTY
                    elif outer_hi:
                        status = SolverStatus.MAX_OUTER_ITERATIONS
                    elif total_hi:
                        status = SolverStatus.MAX_ITERATIONS
                    else:
                        status = SolverStatus.UNSOLVED
                    done = (
                        (not inner_ok) or sat or pen_hi or outer_hi or total_hi
                    )

                with timer.scope("penalty_update"):
                    al = al_new if done else fns.update_penalties(al_new)
                out = res
                if done:
                    break

            result = ALResult(
                Z=Z, al=al, status=jnp.int32(status), stats=stats,
                K=out["K"], d=out["d"],
            )
        self._finish(status)
        return result

    def _finish(self, status) -> None:
        """Final status line + profile emission per options
        (`al_solver.hpp:307-309`, `solver_stats.cpp:68-78`)."""
        opts = self.opts
        if self.logger.level > LogLevel.SILENT:
            print(f"status: {SolverStatus(int(status)).name}")
        if not opts.profiler_enable:
            return
        if opts.profiler_output_to_file:
            directory = opts.log_directory or "."
            os.makedirs(directory, exist_ok=True)
            path = os.path.join(directory, opts.profile_filename)
            with open(path, "w") as f:
                self.timer.print_summary(file=f)
        else:
            self.timer.print_summary()
