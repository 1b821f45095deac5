"""Solver options.

Mirrors the reference's flat options struct (`altro/common/solver_options.hpp:19-65`)
plus the penalty-scaling default that the reference keeps on the constraint
object (`altro/constraints/constraint_values.hpp:30`).

Options are a *static* (hashable) dataclass: the jitted solver closes over
them, so changing an option re-specializes the program — matching the
reference semantics of reading options at solve time while letting XLA
constant-fold every tolerance and schedule parameter.
"""
from __future__ import annotations

import dataclasses
import enum


class LogLevel(enum.IntEnum):
    """Console verbosity levels (`altro/common/log_entry.hpp:27-34`)."""

    SILENT = 0
    OUTER = 1
    OUTER_DEBUG = 2
    INNER = 3
    INNER_DEBUG = 4
    DEBUG = 5


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    # Iteration caps (`solver_options.hpp:23-25`)
    max_iterations_total: int = 300
    max_iterations_outer: int = 30
    max_iterations_inner: int = 100

    # Convergence tolerances (`solver_options.hpp:26-27`)
    cost_tolerance: float = 1e-4
    gradient_tolerance: float = 1e-2

    # Backward-pass regularization schedule (`solver_options.hpp:29-35`)
    bp_reg_increase_factor: float = 1.6
    # Reserved, like the reference: altro-cpp declares bp_reg_enable but
    # never reads it (`solver_options.hpp:30` is its only occurrence);
    # kept for option-surface parity.
    bp_reg_enable: bool = True
    bp_reg_initial: float = 0.0
    bp_reg_max: float = 1e8
    bp_reg_min: float = 1e-8
    bp_reg_fail_threshold: int = 100

    # Forward-pass rollout guards (`solver_options.hpp:36-38`)
    check_forwardpass_bounds: bool = True
    state_max: float = 1e8
    control_max: float = 1e8

    # Line search (`solver_options.hpp:40-43`)
    line_search_max_iterations: int = 20
    line_search_lower_bound: float = 1e-8
    line_search_upper_bound: float = 10.0
    line_search_decrease_factor: float = 2.0

    # Augmented Lagrangian (`solver_options.hpp:45-48`,
    # `constraint_values.hpp:30` for penalty_scaling)
    constraint_tolerance: float = 1e-4
    maximum_penalty: float = 1e8
    initial_penalty: float = 1.0
    penalty_scaling: float = 10.0
    reset_duals: bool = True

    # Logging / profiling (`solver_options.hpp:49-54`)
    header_frequency: int = 10
    verbose: LogLevel = LogLevel.SILENT
    profiler_enable: bool = False
    profiler_output_to_file: bool = False
    log_directory: str = ""
    profile_filename: str = "profiler.out"

    # Numerical-floor stall exit.  In low precision (f32) an inner
    # solve can reach its floor: dJ rounds to ~0 every iteration while the
    # gradient proxy hovers just above tolerance, burning max_iterations_inner
    # (and in a batched solve, stalling the whole lockstep batch).  After this
    # many consecutive iterations with dJ < cost_tolerance the solver exits as
    # converged-at-floor.  Set high enough that it can never fire on a
    # normally-converging solve (goldens converge the same iteration dJ and
    # gradient cross tolerance); 0 disables.
    max_stall_iterations: int = 10

    # Whether a FEASIBLE instance whose inner solve stall-exited terminates
    # the outer loop as SOLVED_STALLED (True), or keeps escalating the
    # penalty until the inner solve genuinely converges (False — closer to
    # the reference, whose outer loop only stops at viol<tol AND inner
    # kSolved, `al_solver.hpp:369-401`).  The r3 straggler diagnosis
    # showed the stalled-feasible instances DO
    # reach SOLVED in f32 once the penalty hits ~1e7-1e8: the larger AL
    # terms lift the cost landscape out of the f32 line-search floor.  With
    # False, an instance that still can't converge exits at the penalty/
    # iteration caps and is labeled SOLVED_STALLED (never worse than the
    # True behavior).  The compacted solver's tail phase sets False
    # (CompactedALSolver finish_stalled) to drive fleets to 100% SOLVED.
    stalled_feasible_exits: bool = True

    # Gain-magnitude guard on the backward pass (r4).  A finite-but-
    # numerically-singular regularized Quu passes the Cholesky NaN check
    # (Eigen LLT has the same hole: only non-positive pivots fail,
    # `knot_point_function_type.hpp:197-211`) and yields astronomically
    # large K/d; every line-search rollout then trips the divergence guard
    # and the solve hard-aborts with STATE_LIMIT instead of retrying — the
    # quadrotor order-dependent failure signature (see
    # perf/quadrotor_path_stability.py).  Gains above this bound can never
    # produce an accepted step (the rollout guard fires at
    # ‖x‖ > state_max = 1e8 first), so treating them as backward-pass
    # failure is semantics-preserving: the pass retries with increased
    # regularization exactly as for an explicit Cholesky failure.
    bp_gain_limit: float = 1e8

    # Matmul precision for solver math.  On the H100, XLA may run f32
    # matmuls in TF32 (about three decimal digits), which destroys
    # Riccati/Cholesky conditioning; "highest" keeps full f32 products and
    # accumulation.  The solver's matrices are tiny (n, m ≤ ~13 per knot)
    # and its small-matrix algebra is elementwise multiply-reduce, not
    # tensor-core work, so this costs nothing.
    matmul_precision: str = "highest"

    # Unroll factor for the time-axis scans in the batch-native solver
    # (Riccati sweep, rollouts).  Unrolling lets XLA fuse across consecutive
    # knot points, amortizing per-step HBM round trips of the tiny carries.
    scan_unroll: int = 1

    # Backward-pass kernel selection for the batch-native solver: "scan"
    # (sequential Riccati recursion over materialized expansions, the
    # parity oracle) or "fused" (expansions computed INSIDE one Pallas
    # kernel that also runs the Riccati sweep — no materialized [N,·,·,B]
    # expansion tensors, J0 for free; `ops/backward_fused_pallas.py`,
    # falls back to "scan" on ineligible problems).  The reference's loop
    # is strictly sequential (`ilqr/ilqr.hpp:402-441`); both run it per
    # lane.
    #
    # "pscan" (associative-scan parallel Riccati, arXiv:1809.06360) was
    # RETIRED as an option in r5: it was measured slower than the
    # sequential sweep at every (N, B) (PARITY.md) and its f32 element
    # composition diverges in its only motivating regime (N >= 2048).  The
    # implementation remains as a tested research note
    # (`solver/pscan.py`, `solver/pscan_batched.py`).
    backward_pass: str = "scan"

    # Forward-pass kernel selection for the batch-native solver: "scan"
    # (XLA time scans for rollout + cost) or "pallas" (one Pallas kernel
    # for the whole rollout + cost, `ops/forward_pallas.py`; requires a
    # kernel-eligible problem structure — falls back to the scans
    # otherwise).  The kernels compile through Triton on the GPU and run in
    # interpret mode on the CPU; other platforms raise.
    forward_pass: str = "scan"

    # Evaluate the batched solver's OUTER-loop constraint values, dual
    # updates (λ ← Π(λ−ρc)), and max-violation measure in float64.
    # These run once per outer iteration on
    # small arrays, so the cost is negligible — but they are exactly where
    # the f32 error in c is amplified by penalties up to 1e8
    # (`constraint_values.hpp:192-207`): an f32 dual update injects
    # ρ·O(1e-7) noise into λ, and an f32 violation measure cannot resolve
    # the 1e-4 tolerance it is compared against.  Off by default so the
    # batched solver stays bit-comparable with the per-instance f32
    # solver; the shipped bench configs enable it.
    outer_constraints_f64: bool = False

    # Speculative (parallel) line search width for the batch-native solver's
    # fused Pallas forward pass.  The backtracking search is lockstep across
    # the batch: one instance needing k halvings makes ALL instances pay k
    # rollout+cost rounds (`ilqr.hpp:525-545` run per instance on CPU; here
    # the while_loop trip count is the batch max).  With S > 1 the solver
    # evaluates S candidate step sizes α·(1, ½, …, ½^(S-1)) in ONE kernel
    # call at S× lane width, and each instance accepts the FIRST passing
    # candidate — bit-identical to the sequential halving sequence
    # (tested).  It pays only when a widened call costs well under S single
    # tries and the line search backtracks deeply most iterations.
    # 1 (default) disables; only the Pallas forward path speculates.
    line_search_parallel: int = 1

    # Capacity of the per-iteration statistics arrays.  The reference grows
    # std::vectors (`solver_stats.cpp:25-29`); under jit we preallocate.
    stats_capacity: int = 304

    # Per-iteration history rows in the BATCHED solver ([capacity, 8, B],
    # `solver/batched.py:BatchedStats.rows`) — the batched analog of the
    # reference's per-iteration stats vectors (`solver_stats.hpp:54-61`).
    # 0 (default) disables recording; the throughput path pays nothing.
    # Set >= max_iterations_total to keep every iteration.
    iteration_history_capacity: int = 0

    # Whether the AL outer loop updates duals when the inner solve ended
    # without converging.  True matches the reference, which updates duals
    # unconditionally before the abort check (`al_solver.hpp:314-345`) — fine
    # when the solve terminates there.  Phased/compacted solves that RESUME
    # from a capped inner solve set this False: λ ← Π(λ−ρc) evaluated at an
    # unconverged trajectory poisons the dual estimate and can drive the
    # resumed solve to MAX_PENALTY (see solver/compaction.py).
    update_duals_on_failed_inner: bool = True

    def replace(self, **updates):
        return dataclasses.replace(self, **updates)
