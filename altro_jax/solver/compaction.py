"""Straggler compaction for the batch-native AL-iLQR solver.

A lockstep batched solve runs until its SLOWEST instance converges: on the
unicycle-parking fleet the median instance needs ~11 total iterations, the
99th percentile ~21, the worst ~65 (`perf/benchmark_scaling.py` prints the
distribution).  Every iteration past p99 runs full-batch kernels to advance
<1% of the instances — the batched analog of the reference looping solves on
one core and blocking on the slowest (`perf/benchmark_unicycle.cpp:45-75`).

`CompactedALSolver` fixes this at the host level without touching the
per-instance algorithm: run the full batch for a capped iteration budget,
gather the unconverged stragglers into a small dense batch (`jnp.take` along
the lane axis), continue only those, and scatter results back.  Each phase
is the same jitted `ALSolverBatched.solve` program; phase boundaries restart
the inner solver (open-loop rollout from the current controls, fresh
regularization and line-search state) while duals and penalties carry over —
the same warm-start semantics the reference defines for re-solves
(`al_solver.hpp:288-302` with reset_duals=false, initial_penalty kept).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..options import SolverOptions
from ..problem.problem import CompiledProblem
from ..types import SolverStatus
from .batched import ALSolverBatched, BatchedTrajectory

# statuses that mean "ran out of a PHASE budget, still making progress" —
# only meaningful after a capped phase.  After an UNCAPPED tail round the
# instance already received the reference's own full iteration budget
# (`solver_options.hpp:23-25`), so the same codes are terminal there, exactly
# as a non-solved inner status aborts the reference's outer loop
# (`al_solver.hpp:378-381`); resuming would livelock on genuinely
# non-converging instances (each round burning max_iterations_inner again).
_RESUMABLE = (
    SolverStatus.MAX_ITERATIONS,
    SolverStatus.MAX_INNER_ITERATIONS,
    SolverStatus.MAX_OUTER_ITERATIONS,
    SolverStatus.UNSOLVED,
)


class CompactedALSolver:
    """Host-orchestrated two-level batched AL-iLQR solve.

    Parameters
    ----------
    phase1_iters : total-iteration cap for the full-batch phase.  Set it near
        the fleet's p95-p99 iteration count; stragglers past it move to the
        compact tail phase.
    tail_batch : lane width of the compact tail phase (instances gathered per
        tail round).  Must be >0.  Widths that keep the Pallas kernels
        eligible (multiples of 1024) run ~6x cheaper per lockstep iteration
        than the scan fallback (`perf/profile_batch_scaling.py`).
    tail_iters : per-round total-iteration cap for tail rounds (0 =
        uncapped).  Capped rounds re-compact between rounds, so lanes whose
        instance converged mid-round are dropped instead of idling until the
        chunk's slowest instance finishes.
    max_tail_rounds : tail rounds before giving up and reporting the last
        status (prevents livelock on genuinely non-converging instances).
    finish_stalled : the tail phase runs with
        `stalled_feasible_exits=False` and treats SOLVED_STALLED as
        resumable, so feasible-but-stalled instances keep escalating the
        penalty until their inner solve genuinely converges — drives the
        fleet to 100% SOLVED (r3 left 2/4096 SOLVED_STALLED; their
        diagnosed fix is exactly this escalation).
    f64_polish : after the tail rounds, re-solve any still-unconverged
        instances in FLOAT64 on the scan path (fresh duals, warm-started
        from their f32 trajectories, reference-default line search).
        Measured motivation: ~11% of the
        perturbed three-obstacle fleet ends MAX_PENALTY in f32 while every
        such instance solves outright in f64 — the failures are an f32
        precision floor, not algorithmic.  Zero-cost when the f32 phases
        already solved everything (the parking fleet).
    polish_batch : lane width of the f64 polish phase.

    After each `solve`, `self.telemetry` holds phase wall times, straggler
    counts per round, and the iteration-count distribution — the data that
    tunes `phase1_iters` (the reference records per-iteration stats vectors
    for the same purpose, `solver_stats.hpp:54-61`).
    """

    def __init__(
        self,
        prob: CompiledProblem,
        opts: SolverOptions = None,
        *,
        phase1_iters: int = 20,
        tail_batch: int = 1024,
        tail_iters: int = 0,
        max_tail_rounds: int = 8,
        finish_stalled: bool = True,
        f64_polish: bool = False,
        polish_batch: int = 512,
        device_tail: bool = False,
        device_tail_rounds: int = 0,
        restart_portfolio: tuple = (),
        restart_width: int = 0,
        restart_rounds: int = 1,
        detect_infeasible: bool = False,
        infeasible_step_bound: float = 0.0,
    ):
        self.prob = prob
        self.opts = opts or SolverOptions()
        self.phase1_iters = int(phase1_iters)
        self.tail_batch = int(tail_batch)
        self.tail_iters = int(tail_iters)
        self.max_tail_rounds = int(max_tail_rounds)
        self.finish_stalled = bool(finish_stalled)
        self.f64_polish = bool(f64_polish)
        self.polish_batch = int(polish_batch)
        self.device_tail = bool(device_tail)
        self.device_tail_rounds = int(device_tail_rounds)
        # Restart portfolio (r5, device path only): after the tail rounds,
        # re-solve the still-unSOLVED residue FRESH (original initial
        # guess, zero duals) under a CASCADE of penalty-ladder variants —
        # each variant gathers whatever every earlier one failed, so the
        # deep/gentle ladders only ever see the hard residue.  All f32, on
        # the same fused kernels, inside the same single-dispatch device
        # program.  Measured on the three-obstacle fleet: 91.7% → 99.7%
        # SOLVED with no f64 re-solve tail.  Each entry is a dict with any
        # of `penalty_scaling`, `initial_penalty`, `max_iterations_outer`,
        # `max_iterations_total`.
        self.restart_portfolio = tuple(restart_portfolio)
        self.restart_width = int(restart_width)
        self.restart_rounds = int(restart_rounds)
        # Structural infeasibility certificates (r5): provably-conflicting
        # layouts (goal inside an obstacle — `problem/infeasibility.py`)
        # never iterate and report SolverStatus.INFEASIBLE, so fleet
        # solved%% measures the solver, not the sampler.
        self.detect_infeasible = bool(detect_infeasible)
        self.infeasible_step_bound = float(infeasible_step_bound)
        if self.restart_portfolio and not self.device_tail:
            raise ValueError("restart_portfolio requires device_tail=True")
        if self.detect_infeasible and not self.device_tail:
            raise ValueError("detect_infeasible requires device_tail=True")
        self._polish_solve = None
        self._device_solve = None
        self.telemetry: dict = {}

        # Phases never update duals from a capped (unconverged) inner solve —
        # the update is only meaningful at an inner optimum, and the
        # instances it would hit are exactly the ones that resume.
        p1_opts = self.opts.replace(
            max_iterations_total=min(
                self.phase1_iters, self.opts.max_iterations_total
            ),
            update_duals_on_failed_inner=False,
        )
        # Tail phases resume the AL state: keep duals, keep penalties.
        tail_opts = self.opts.replace(
            reset_duals=False,
            initial_penalty=0.0,
            update_duals_on_failed_inner=False,
        )
        if self.finish_stalled:
            tail_opts = tail_opts.replace(stalled_feasible_exits=False)
        if self.tail_iters > 0:
            tail_opts = tail_opts.replace(
                max_iterations_total=min(
                    self.tail_iters, tail_opts.max_iterations_total
                )
            )
        self._p1 = ALSolverBatched(prob, p1_opts)
        self._tail = ALSolverBatched(prob, tail_opts)
        self._p1_solve = jax.jit(self._p1.solve)
        self._tail_solve = jax.jit(self._tail.solve)
        self._restart = None
        if self.restart_portfolio:
            # fresh-start solver: duals/penalties come in via the explicit
            # al argument (per-variant), so disable the al transforms
            self._restart = ALSolverBatched(
                prob,
                self.opts.replace(
                    reset_duals=False,
                    initial_penalty=0.0,
                    update_duals_on_failed_inner=False,
                ),
            )

    # ------------------------------------------------------------- helpers
    @staticmethod
    def _gather(tree, idx):
        return jax.tree_util.tree_map(lambda leaf: leaf[..., idx], tree)

    @staticmethod
    def _scatter(tree, idx, sub):
        return jax.tree_util.tree_map(
            lambda leaf, s: leaf.at[..., idx].set(s), tree, sub
        )

    def _gather_Z(self, Z: BatchedTrajectory, idx) -> BatchedTrajectory:
        return dataclasses.replace(Z, X=Z.X[..., idx], U=Z.U[..., idx])

    # ------------------------------------------------------ device-side tail
    def _resumable_codes(self) -> list:
        codes = [int(s) for s in _RESUMABLE]
        if self.finish_stalled:
            codes.append(int(SolverStatus.SOLVED_STALLED))
        return codes

    def _build_device_solve(self):
        """One jitted program: capped phase-1 + `device_tail_rounds` rounds
        of ON-DEVICE straggler compaction (argsort-gather the unconverged
        lanes into a dense tail batch, solve with an active mask, scatter
        back).  The host version pays a host↔device round trip per phase
        boundary; this runs the whole pipeline in ONE dispatch.  A round whose gathered lanes are
        all finished costs nothing (the masked solve's while loops exit
        immediately), so unneeded rounds are ~free."""
        import jax
        import jax.numpy as jnp

        K_t = self.tail_batch
        codes_np = np.asarray(self._resumable_codes(), np.int32)
        canon = self.prob.params

        def gather_params(params, idx):
            return jax.tree_util.tree_map(
                lambda c, leaf: (
                    leaf[..., idx]
                    if jnp.ndim(leaf) == jnp.ndim(c) + 1
                    else leaf
                ),
                canon,
                params,
            )

        def run(params, Zb, al):
            B = Zb.X.shape[-1]
            infeasible = None
            if self.detect_infeasible:
                from ..problem.infeasibility import goal_obstacle_certificates

                infeasible = goal_obstacle_certificates(
                    self.prob, params, B,
                    step_bound=self.infeasible_step_bound,
                )
                res = self._p1.solve(params, Zb, al, active=~infeasible)
            else:
                res = self._p1.solve(params, Zb, al)
            # enough rounds to cover EVERY lane (matching the host path,
            # which chunks all stragglers each round); rounds whose
            # gathered lanes are already finished are ~free
            rounds = self.device_tail_rounds or -(-B // K_t)
            codes = jnp.asarray(codes_np)
            # a lane that RAN an (uncapped) tail round is terminal — it
            # received the full reference iteration budget (host-path
            # `undone &= False` analog); without this a SOLVED_STALLED
            # lane would be re-gathered every round
            tried = jnp.zeros((B,), bool)
            if infeasible is not None:
                tried = tried | infeasible  # certified lanes never resume
            for _ in range(rounds):
                status = res["status"]
                undone = (status[:, None] == codes[None, :]).any(axis=1)
                undone = undone & ~tried
                # unconverged lanes first, stable order; take a dense K_t
                order = jnp.argsort(~undone, stable=True)
                idx = order[:K_t]
                real = undone[idx]
                params_t = gather_params(params, idx)
                Z_t = self._gather_Z(res["Z"], idx)
                al_t = self._gather(res["al"], idx)
                sub = self._tail.solve(params_t, Z_t, al_t, active=real)
                res = self._merge_device(res, sub, idx, real)
                tried = tried.at[idx].set(tried[idx] | real)

            V = len(self.restart_portfolio)
            if V:
                res = self._portfolio_rounds(
                    params, Zb, res, V, skip=infeasible
                )
            if infeasible is not None:
                res = dict(res)
                res["status"] = jnp.where(
                    infeasible,
                    jnp.int32(SolverStatus.INFEASIBLE),
                    res["status"],
                )
            return res

        return run

    def _portfolio_rounds(self, params, Zb, res, V, skip=None):
        """Fresh-restart cascade stage of the device program — see the
        `restart_portfolio` constructor doc.

        The variants run SEQUENTIALLY, each on the instances every earlier
        variant failed: a side-by-side (lane-tiled) portfolio was measured
        3x slower on the three-obstacle fleet because its single lockstep
        runs to the DEEPEST variant's trip count for every instance, while
        the cascade pays each variant's depth only for the (shrinking)
        residue that reaches it.
        """
        import jax
        import jax.numpy as jnp

        opts = self.opts
        canon = self.prob.params
        dt = Zb.X.dtype
        B = res["status"].shape[0]
        R = self.restart_width or self.tail_batch

        def gp(params, idx):
            return jax.tree_util.tree_map(
                lambda c, leaf: (
                    leaf[..., idx]
                    if jnp.ndim(leaf) == jnp.ndim(c) + 1
                    else leaf
                ),
                canon,
                params,
            )

        solved_code = jnp.int32(SolverStatus.SOLVED)
        for _ in range(self.restart_rounds):
            for variant in self.restart_portfolio:
                lane_opts = dict(
                    penalty_scaling=jnp.full(
                        (R,),
                        variant.get("penalty_scaling", opts.penalty_scaling),
                        dt,
                    ),
                    max_iterations_outer=jnp.full(
                        (R,),
                        variant.get(
                            "max_iterations_outer", opts.max_iterations_outer
                        ),
                        jnp.int32,
                    ),
                    max_iterations_total=jnp.full(
                        (R,),
                        variant.get(
                            "max_iterations_total", opts.max_iterations_total
                        ),
                        jnp.int32,
                    ),
                )
                rho0 = variant.get("initial_penalty", opts.initial_penalty)
                al_r = tuple(
                    dict(
                        lam=jnp.zeros((len(f.knots), f.dim, R), dt),
                        rho=jnp.full((len(f.knots), R), rho0, dt),
                    )
                    for f in self.prob.constraint_families
                )
                undone = res["status"] != solved_code
                if skip is not None:
                    undone = undone & ~skip
                order = jnp.argsort(~undone, stable=True)
                idx = order[:R]
                real = undone[idx]
                params_r = gp(params, idx)
                # restarts begin from the ORIGINAL initial guess, not the
                # failed high-penalty trajectory (measured: warm-starting
                # the restart converts fewer)
                Z_r = dataclasses.replace(
                    Zb, X=Zb.X[..., idx], U=Zb.U[..., idx]
                )
                sub = self._restart.solve(
                    params_r, Z_r, al_r, active=real, lane_opts=lane_opts
                )
                ok = sub["status"] == solved_code
                res = self._merge_device(res, sub, idx, real & ok)
        return res

    @staticmethod
    def _merge_device(res, sub, idx, real):
        """Scatter a tail round's results back into the full-batch result,
        masked to the real (unconverged-gathered) lanes."""
        import jax
        import jax.numpy as jnp

        def sel(old, new):
            return old.at[..., idx].set(jnp.where(real, new, old[..., idx]))

        res = dict(res)
        res["Z"] = dataclasses.replace(
            res["Z"], X=sel(res["Z"].X, sub["Z"].X), U=sel(res["Z"].U, sub["Z"].U)
        )
        res["al"] = jax.tree_util.tree_map(sel, res["al"], sub["al"])
        res["K"] = sel(res["K"], sub["K"])
        res["d"] = sel(res["d"], sub["d"])
        res["status"] = res["status"].at[idx].set(
            jnp.where(real, sub["status"], res["status"][idx])
        )
        st, su = res["stats"], sub["stats"]
        reali = real.astype(st.iterations_outer.dtype)
        rows = st.rows
        cap = rows.shape[0]
        if cap > 0:
            T0 = st.iterations_total[idx]
            r = jnp.arange(cap)
            valid = (r[:, None] < su.iterations_total[None, :]) & real[None, :]
            dst = jnp.where(valid, T0[None, :] + r[:, None], cap)
            lanes = jnp.broadcast_to(idx[None, :], dst.shape)
            rows = rows.at[dst, :, lanes].set(
                jnp.moveaxis(su.rows, 1, 2), mode="drop"
            )

        def sset(o, n_):
            return o.at[idx].set(jnp.where(real, n_, o[idx]))

        res["stats"] = st.replace(
            iterations_inner=sset(st.iterations_inner, su.iterations_inner),
            iterations_outer=st.iterations_outer.at[idx].add(
                su.iterations_outer * reali
            ),
            iterations_total=st.iterations_total.at[idx].add(
                su.iterations_total * reali
            ),
            cost=sset(st.cost, su.cost),
            cost_decrease=sset(st.cost_decrease, su.cost_decrease),
            gradient=sset(st.gradient, su.gradient),
            alpha=sset(st.alpha, su.alpha),
            improvement_ratio=sset(st.improvement_ratio, su.improvement_ratio),
            violations=sset(st.violations, su.violations),
            max_penalty=sset(st.max_penalty, su.max_penalty),
            regularization=sset(st.regularization, su.regularization),
            rows=rows,
        )
        return res

    def _solve_device(self, params, Z: BatchedTrajectory, al=None):
        """`solve` with the single-dispatch device-side tail (see
        `_build_device_solve`); the f64 polish (rare path) stays host-side
        and costs one status readback."""
        import time as _time

        import jax

        t0 = _time.perf_counter()
        if self._device_solve is None:
            self._device_solve = jax.jit(self._build_device_solve())
        res = self._device_solve(params, Z, al)
        res = dict(res)
        jax.block_until_ready(res["status"])
        tel = {"phase1_s": _time.perf_counter() - t0, "tail_rounds": "device"}
        if self.f64_polish:
            hard = [int(s) for s in _RESUMABLE] + [int(SolverStatus.MAX_PENALTY)]
            stages = [
                (hard + [int(SolverStatus.SOLVED_STALLED)], {}),
                (hard, dict(
                    penalty_scaling=4.0,
                    max_iterations_outer=60,
                    max_iterations_total=900,
                )),
            ]
            stage_tel = []
            for si, (codes, extra) in enumerate(stages):
                bad = np.isin(
                    np.asarray(res["status"]), np.asarray(codes, np.int32)
                )
                if not bad.any():
                    continue
                t_p = _time.perf_counter()
                n_bad = int(bad.sum())
                self._run_polish(params, res, np.nonzero(bad)[0], Z, si, extra)
                jax.block_until_ready(res["status"])
                stage_tel.append(
                    {"stage": si, "instances": n_bad,
                     "wall_s": _time.perf_counter() - t_p}
                )
            if stage_tel:
                st = np.asarray(res["status"])
                tel["polish"] = {
                    "instances": stage_tel[0]["instances"],
                    "stages": stage_tel,
                    "wall_s": sum(s["wall_s"] for s in stage_tel),
                    "solved_after": int(
                        np.sum(st == int(SolverStatus.SOLVED))
                    ),
                }
        it = np.asarray(res["stats"].iterations_total)
        tel["iters_p50"] = float(np.percentile(it, 50))
        tel["iters_p95"] = float(np.percentile(it, 95))
        tel["iters_p99"] = float(np.percentile(it, 99))
        tel["iters_max"] = int(it.max())
        tel["total_s"] = _time.perf_counter() - t0
        self.telemetry = tel
        return res

    # --------------------------------------------------------------- solve
    def solve(self, params, Z: BatchedTrajectory, al=None):
        """Same contract as `ALSolverBatched.solve` (batch-last dict)."""
        import time as _time

        if self.device_tail:
            if self.tail_iters > 0:
                raise ValueError(
                    "device_tail supports uncapped tail rounds only "
                    "(tail_iters=0)"
                )
            return self._solve_device(params, Z, al)

        t0 = _time.perf_counter()
        res = self._p1_solve(params, Z, al)
        jax.block_until_ready(res["status"])
        tel = {
            "phase1_s": _time.perf_counter() - t0,
            "tail_rounds": [],
        }
        resumable = _RESUMABLE
        if self.finish_stalled:
            # stall-exited feasible instances re-enter the tail, whose
            # stalled_feasible_exits=False config escalates them to SOLVED
            resumable = resumable + (SolverStatus.SOLVED_STALLED,)
        status = np.asarray(res["status"])
        undone = np.isin(status, np.asarray(resumable, status.dtype))
        rounds = 0
        while undone.any() and rounds < self.max_tail_rounds:
            rounds += 1
            t_round = _time.perf_counter()
            n_stragglers = int(undone.sum())
            idx_all = np.nonzero(undone)[0]
            for start in range(0, len(idx_all), self.tail_batch):
                chunk = idx_all[start : start + self.tail_batch]
                # pad to the fixed tail width by repeating (duplicate solves
                # write identical values back via `.set`; shapes stay static
                # for jit).  `.add` merges would double-count the duplicated
                # instance, so counter increments are masked to real rows.
                npad = self.tail_batch - len(chunk)
                if npad > 0:
                    idx = np.concatenate([chunk, np.full(npad, chunk[0])])
                    real = jnp.asarray(
                        np.concatenate(
                            [np.ones(len(chunk), np.int32), np.zeros(npad, np.int32)]
                        )
                    )
                else:
                    idx = chunk
                    real = jnp.ones((self.tail_batch,), jnp.int32)
                idx_j = jnp.asarray(idx)
                # gather every per-instance (trailing-batch) param leaf —
                # x0 and any batched cost/constraint/dynamics data
                params_t = jax.tree_util.tree_map(
                    lambda c, leaf: (
                        leaf[..., idx_j]
                        if jnp.ndim(leaf) == jnp.ndim(c) + 1
                        else leaf
                    ),
                    self.prob.params,
                    params,
                )
                Z_t = self._gather_Z(res["Z"], idx_j)
                al_t = self._gather(res["al"], idx_j)
                sub = self._tail_solve(params_t, Z_t, al_t)
                # merge: trajectories/status/duals replace, counters add
                res["Z"] = dataclasses.replace(
                    res["Z"],
                    X=res["Z"].X.at[..., idx_j].set(sub["Z"].X),
                    U=res["Z"].U.at[..., idx_j].set(sub["Z"].U),
                )
                res["al"] = self._scatter(res["al"], idx_j, sub["al"])
                res["K"] = res["K"].at[..., idx_j].set(sub["K"])
                res["d"] = res["d"].at[..., idx_j].set(sub["d"])
                res["status"] = res["status"].at[idx_j].set(sub["status"])
                st, su = res["stats"], sub["stats"]
                rows = st.rows
                cap = rows.shape[0]
                if cap > 0:
                    # splice the tail round's history after each instance's
                    # prior iterations: res.rows[T0[b]+r, :, idx[b]] =
                    # sub.rows[r, :, b] for r < tail iterations; padded
                    # duplicates and out-of-capacity rows drop
                    T0 = st.iterations_total[idx_j]  # before the .add below
                    r = jnp.arange(cap)
                    valid = (r[:, None] < su.iterations_total[None, :]) & (
                        real[None, :] > 0
                    )
                    dst = jnp.where(valid, T0[None, :] + r[:, None], cap)
                    lanes = jnp.broadcast_to(idx_j[None, :], dst.shape)
                    rows = rows.at[dst, :, lanes].set(
                        jnp.moveaxis(su.rows, 1, 2), mode="drop"
                    )
                res["stats"] = st.replace(
                    iterations_inner=st.iterations_inner.at[idx_j].set(
                        su.iterations_inner
                    ),
                    iterations_outer=st.iterations_outer.at[idx_j].add(
                        su.iterations_outer * real
                    ),
                    iterations_total=st.iterations_total.at[idx_j].add(
                        su.iterations_total * real
                    ),
                    cost=st.cost.at[idx_j].set(su.cost),
                    cost_decrease=st.cost_decrease.at[idx_j].set(su.cost_decrease),
                    gradient=st.gradient.at[idx_j].set(su.gradient),
                    alpha=st.alpha.at[idx_j].set(su.alpha),
                    improvement_ratio=st.improvement_ratio.at[idx_j].set(
                        su.improvement_ratio
                    ),
                    violations=st.violations.at[idx_j].set(su.violations),
                    max_penalty=st.max_penalty.at[idx_j].set(su.max_penalty),
                    regularization=st.regularization.at[idx_j].set(
                        su.regularization
                    ),
                    rows=rows,
                )
            jax.block_until_ready(res["status"])
            status = np.asarray(res["status"])
            undone = np.isin(status, np.asarray(resumable, status.dtype))
            if self.tail_iters == 0:
                # every straggler just ran an UNCAPPED round (the full
                # reference iteration budget): budget-exhaustion statuses
                # are terminal, see _RESUMABLE note above
                undone &= False
            tel["tail_rounds"].append(
                {
                    "stragglers": n_stragglers,
                    "wall_s": _time.perf_counter() - t_round,
                }
            )
        if self.f64_polish:
            hard = [int(s) for s in _RESUMABLE] + [int(SolverStatus.MAX_PENALTY)]
            # stage 0 re-solves everything unconverged (incl. stalled);
            # stage 1 retries only remaining HARD failures with a gentler
            # x4 penalty ladder (more dual updates per decade) — it must
            # not touch stalled-feasible results, which the x10 ladder
            # serves better (measured both ways on the seed-0 residue)
            stages = [
                (hard + [int(SolverStatus.SOLVED_STALLED)], {}),
                (hard, dict(
                    penalty_scaling=4.0,
                    max_iterations_outer=60,
                    max_iterations_total=900,
                )),
            ]
            stage_tel = []
            for si, (codes, extra) in enumerate(stages):
                bad = np.isin(
                    np.asarray(res["status"]), np.asarray(codes, np.int32)
                )
                if not bad.any():
                    continue
                t_p = _time.perf_counter()
                n_bad = int(bad.sum())
                self._run_polish(params, res, np.nonzero(bad)[0], Z, si, extra)
                jax.block_until_ready(res["status"])
                stage_tel.append(
                    {"stage": si, "instances": n_bad,
                     "wall_s": _time.perf_counter() - t_p}
                )
            if stage_tel:
                st = np.asarray(res["status"])
                tel["polish"] = {
                    "instances": stage_tel[0]["instances"],
                    "stages": stage_tel,
                    "wall_s": sum(s["wall_s"] for s in stage_tel),
                    "solved_after": int(
                        np.sum(st == int(SolverStatus.SOLVED))
                    ),
                }

        it = np.asarray(res["stats"].iterations_total)
        tel["iters_p50"] = float(np.percentile(it, 50))
        tel["iters_p95"] = float(np.percentile(it, 95))
        tel["iters_p99"] = float(np.percentile(it, 99))
        tel["iters_max"] = int(it.max())
        tel["total_s"] = _time.perf_counter() - t0
        self.telemetry = tel
        return res

    # ------------------------------------------------------------ f64 polish
    def _run_polish(self, params, res, idx_all, Z0, stage, extra_opts):
        """Re-solve instances `idx_all` in f64 (scan path, fresh duals,
        fresh start from the ORIGINAL initial guess `Z0` — matching the
        oracle experiment that established every f32 failure solves in f64;
        warm-starting from the failed f32 trajectory converts fewer, its
        high-penalty shape traps the solve) and splice the results back
        into `res` in place.  See the `f64_polish` constructor doc."""
        enable_x64 = jax.enable_x64

        pb = min(self.polish_batch, max(len(idx_all), 1))
        f32 = res["Z"].X.dtype

        def cast64(leaf):
            leaf = jnp.asarray(leaf)
            if jnp.issubdtype(leaf.dtype, jnp.floating):
                return leaf.astype(jnp.float64)
            return leaf

        with enable_x64():
            if self._polish_solve is None:
                self._polish_solve = {}
            if stage not in self._polish_solve:
                popts = self.opts.replace(
                    backward_pass="scan",
                    forward_pass="scan",
                    line_search_max_iterations=20,
                    max_stall_iterations=10,
                    stalled_feasible_exits=False,
                    reset_duals=True,
                    **extra_opts,
                )
                self._polish_solve[stage] = jax.jit(
                    ALSolverBatched(self.prob, popts).solve
                )
            for start in range(0, len(idx_all), pb):
                chunk = idx_all[start : start + pb]
                npad = pb - len(chunk)
                if npad > 0:
                    idx = np.concatenate([chunk, np.full(npad, chunk[0])])
                    real = jnp.asarray(
                        np.concatenate(
                            [np.ones(len(chunk), np.int32),
                             np.zeros(npad, np.int32)]
                        )
                    )
                else:
                    idx = chunk
                    real = jnp.ones((pb,), jnp.int32)
                idx_j = jnp.asarray(idx)
                params_t = jax.tree_util.tree_map(
                    lambda c, leaf: cast64(
                        jnp.asarray(leaf)[..., idx_j]
                        if jnp.ndim(leaf) == jnp.ndim(c) + 1
                        else leaf
                    ),
                    self.prob.params,
                    params,
                )
                Zf = self._gather_Z(Z0, idx_j)
                Z_t = dataclasses.replace(
                    Zf, X=cast64(Zf.X), U=cast64(Zf.U),
                    t=cast64(Zf.t), h=cast64(Zf.h),
                )
                sub = self._polish_solve[stage](params_t, Z_t)
                res["Z"] = dataclasses.replace(
                    res["Z"],
                    X=res["Z"].X.at[..., idx_j].set(sub["Z"].X.astype(f32)),
                    U=res["Z"].U.at[..., idx_j].set(sub["Z"].U.astype(f32)),
                )
                res["al"] = jax.tree_util.tree_map(
                    lambda leaf, s: leaf.at[..., idx_j].set(
                        s.astype(leaf.dtype)
                    ),
                    res["al"], sub["al"],
                )
                res["K"] = res["K"].at[..., idx_j].set(sub["K"].astype(f32))
                res["d"] = res["d"].at[..., idx_j].set(sub["d"].astype(f32))
                res["status"] = res["status"].at[idx_j].set(sub["status"])
                st, su = res["stats"], sub["stats"]
                # full stats merge, mirroring the tail-round splice above
                # (incl. rows history): polished instances must not keep
                # stale f32-phase cost_decrease/alpha/z/regularization
                rows = st.rows
                cap = rows.shape[0]
                if cap > 0:
                    T0 = st.iterations_total[idx_j]
                    r = jnp.arange(cap)
                    valid = (r[:, None] < su.iterations_total[None, :]) & (
                        real[None, :] > 0
                    )
                    dst = jnp.where(valid, T0[None, :] + r[:, None], cap)
                    lanes = jnp.broadcast_to(idx_j[None, :], dst.shape)
                    rows = rows.at[dst, :, lanes].set(
                        jnp.moveaxis(su.rows, 1, 2).astype(f32), mode="drop"
                    )
                res["stats"] = st.replace(
                    iterations_inner=st.iterations_inner.at[idx_j].set(
                        su.iterations_inner
                    ),
                    iterations_outer=st.iterations_outer.at[idx_j].add(
                        su.iterations_outer * real
                    ),
                    iterations_total=st.iterations_total.at[idx_j].add(
                        su.iterations_total * real
                    ),
                    cost=st.cost.at[idx_j].set(su.cost.astype(f32)),
                    cost_decrease=st.cost_decrease.at[idx_j].set(
                        su.cost_decrease.astype(f32)
                    ),
                    gradient=st.gradient.at[idx_j].set(
                        su.gradient.astype(f32)
                    ),
                    alpha=st.alpha.at[idx_j].set(su.alpha.astype(f32)),
                    improvement_ratio=st.improvement_ratio.at[idx_j].set(
                        su.improvement_ratio.astype(f32)
                    ),
                    regularization=st.regularization.at[idx_j].set(
                        su.regularization.astype(f32)
                    ),
                    violations=st.violations.at[idx_j].set(
                        su.violations.astype(f32)
                    ),
                    max_penalty=st.max_penalty.at[idx_j].set(
                        su.max_penalty.astype(f32)
                    ),
                    rows=rows,
                )
