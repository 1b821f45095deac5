"""Container & infrastructure semantics tests.

Breadth analogs of the reference suites the framework did not yet mirror:
trajectory container semantics (`test/common/trajectory_test.cpp`,
`altro/common/trajectory.hpp:122-153`), the logger column x verbosity matrix
(`test/common/solver_logging_test.cpp`), timer output format and overhead
(`test/common/timer_test.cpp:37-190`), stats NewIteration carry-forward
(`altro/common/solver_stats.cpp:54-66`), and SOC constraints through a
batched AL solve.
"""
import io
import time
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from altro_jax import SolverOptions
from altro_jax.options import LogLevel
from altro_jax.types import (
    Trajectory,
    initial_trajectory,
    stats_init,
    stats_log,
    stats_new_iteration,
    stats_column,
)
from altro_jax.utils.logging import LogEntry, SolverLogger
from altro_jax.utils.timer import Timer


# --------------------------------------------------------------- trajectory
def test_initial_trajectory_uniform_step():
    """`SetUniformStep` analog (`trajectory.hpp:122-130`)."""
    N, h = 12, 0.25
    Z = initial_trajectory(3, 2, N, h, u0=[0.1, -0.2], x0=[1.0, 2.0, 3.0])
    assert Z.N == N and Z.n == 3 and Z.m == 2
    np.testing.assert_allclose(Z.t, np.arange(N + 1) * h)
    np.testing.assert_allclose(Z.h, np.full(N, h))
    np.testing.assert_allclose(Z.X, np.tile([1.0, 2.0, 3.0], (N + 1, 1)))
    np.testing.assert_allclose(Z.U, np.tile([0.1, -0.2], (N, 1)))


def test_trajectory_time_consistency():
    """`CheckTimeConsistency` analog (`trajectory.hpp:138-153`)."""
    Z = initial_trajectory(2, 1, 10, 0.1)
    np.testing.assert_allclose(np.diff(np.asarray(Z.t)), np.asarray(Z.h),
                               atol=1e-12)


def test_trajectory_upad_terminal_zero_row():
    Z = initial_trajectory(2, 2, 5, 0.1, u0=[3.0, 4.0])
    Up = np.asarray(Z.upad())
    assert Up.shape == (6, 2)
    np.testing.assert_array_equal(Up[-1], [0.0, 0.0])
    np.testing.assert_allclose(Up[:-1], np.asarray(Z.U))


def test_trajectory_pytree_roundtrip_and_jit():
    """Trajectory is a proper pytree: flatten/unflatten and jit-traverse."""
    Z = initial_trajectory(3, 2, 4, 0.5, x0=[1.0, 0.0, 0.0])
    leaves, treedef = jax.tree_util.tree_flatten(Z)
    Z2 = jax.tree_util.tree_unflatten(treedef, leaves)
    assert isinstance(Z2, Trajectory)
    np.testing.assert_array_equal(Z2.X, Z.X)

    @jax.jit
    def scale(Z):
        return Z.replace(U=2.0 * Z.U)

    Z3 = scale(Z)
    np.testing.assert_allclose(Z3.U, 2.0 * np.asarray(Z.U))
    np.testing.assert_array_equal(Z3.t, Z.t)


def test_trajectory_replace_does_not_mutate():
    Z = initial_trajectory(2, 1, 3, 0.1)
    Z2 = Z.replace(U=Z.U + 1.0)
    np.testing.assert_array_equal(np.asarray(Z.U), 0.0)
    np.testing.assert_array_equal(np.asarray(Z2.U), 1.0)


# ------------------------------------------------------------------- logger
_EXPECTED_ACTIVE = {
    LogLevel.SILENT: set(),
    LogLevel.OUTER: {"iter_al", "viol"},
    LogLevel.OUTER_DEBUG: {"iter_al", "viol", "iters", "grad"},
    LogLevel.INNER: {"iter_al", "viol", "iters", "grad", "cost", "dJ", "alpha"},
    LogLevel.INNER_DEBUG: {
        "iter_al", "viol", "iters", "grad", "cost", "dJ", "alpha", "reg", "z",
    },
    LogLevel.DEBUG: {
        "iter_al", "viol", "iters", "grad", "cost", "dJ", "alpha", "reg", "z",
        "pen",
    },
}


@pytest.mark.parametrize("level", list(LogLevel))
def test_logger_column_verbosity_matrix(level):
    """Which default columns are active at each level
    (`solver_stats.cpp:80-114`, `solver_logging_test.cpp` analog)."""
    logger = SolverLogger(level, color=False)
    active = {t for t in logger.entries if logger.active(t)}
    assert active == _EXPECTED_ACTIVE[level]


def test_logger_bounds_coloring():
    """Green below lower bound, red above upper (`log_entry.hpp:78-87`)."""
    e = LogEntry("v", "{:>.2f}", 10, LogLevel.OUTER, lower_bound=1.0,
                 upper_bound=10.0)
    green = e.format_value(0.5, color=True)
    red = e.format_value(50.0, color=True)
    plain = e.format_value(5.0, color=True)
    assert "\x1b[32m" in green and "\x1b[31m" not in green
    assert "\x1b[31m" in red
    assert "\x1b" not in plain
    # colored strings still pad to the visible width
    from altro_jax.utils.logging import _visible_len

    assert _visible_len(green) == 10 and _visible_len(red) == 10


def test_logger_inactive_column_not_rendered():
    logger = SolverLogger(LogLevel.OUTER, color=False)
    logger.log("cost", 123.456)  # INNER-level column: accepted but inactive
    logger.log("viol", 1e-3)
    buf = io.StringIO()
    with redirect_stdout(buf):
        logger.print_row()
    out = buf.getvalue()
    assert "123" not in out and "1e-03" in out.replace("1.000e-03", "1e-03")


def test_logger_header_frequency_unit():
    logger = SolverLogger(LogLevel.OUTER, color=False, frequency=3)
    buf = io.StringIO()
    with redirect_stdout(buf):
        for i in range(7):
            logger.log("viol", float(i))
            logger.print_row()
    lines = [l for l in buf.getvalue().splitlines() if l.strip()]
    headers = [l for l in lines if "viol" in l and "iter_al" in l]
    assert len(headers) == 3  # rows 0, 3, 6


# -------------------------------------------------------------------- timer
def test_timer_hierarchical_keys_and_counts():
    t = Timer(active=True)
    with t.scope("al"):
        for _ in range(3):
            with t.scope("ilqr"):
                with t.scope("backward_pass"):
                    pass
    assert t.get_us("al") > 0
    assert t.get_us("al/ilqr") > 0
    assert t.get_us("al/ilqr/backward_pass") > 0
    assert t._counts["al/ilqr"] == 3
    assert t.get_us("al") >= t.get_us("al/ilqr")


def test_timer_summary_format():
    """Summary matches the reference's table shape
    (`perf/profiler_unicycle.out`): header + indented children + percents."""
    t = Timer(active=True)
    with t.scope("al"):
        with t.scope("ilqr"):
            time.sleep(0.001)
    s = t.summary()
    lines = s.splitlines()
    assert "time (ms)" in lines[0] and "%total" in lines[0] and "%parent" in lines[0]
    assert lines[1].startswith("al")
    assert lines[2].startswith("  ilqr")
    assert "100.0%" in lines[1]


def test_timer_inactive_is_cheap_and_records_nothing():
    """`timer.hpp:27-29`: ~free when off."""
    t = Timer(active=False)
    n = 20000
    t0 = time.perf_counter()
    for _ in range(n):
        with t.scope("x"):
            pass
    dt_us = (time.perf_counter() - t0) / n * 1e6
    assert t.summary() == "(no profile data)\n"
    # generous bound: inactive scope must stay in the ~microsecond range
    # (the reference documents ~10 us for its ACTIVE stopwatch)
    assert dt_us < 50.0


def test_timer_reset():
    t = Timer(active=True)
    with t.scope("a"):
        pass
    t.reset()
    assert t.get_us("a") == 0.0
    assert t.summary() == "(no profile data)\n"


# -------------------------------------------------------------------- stats
def test_stats_new_iteration_carries_forward():
    """`SolverStats::NewIteration` copies the current row forward
    (`solver_stats.cpp:54-66`)."""
    stats = stats_init(8, jnp.float64)
    stats = stats_log(stats, cost=5.0, violations=0.25)
    stats = stats_new_iteration(stats)
    # next row pre-filled with the carried values
    rows = np.asarray(stats.rows)
    assert rows[1, 0] == 5.0 and rows[1, 6] == 0.25
    # overwrite only cost; viol carries
    stats = stats_log(stats, cost=3.0)
    stats = stats_new_iteration(stats)
    rows = np.asarray(stats.rows)
    assert rows[1, 0] == 3.0 and rows[1, 6] == 0.25
    np.testing.assert_allclose(np.asarray(stats_column(stats, "cost"))[:2],
                               [5.0, 3.0])
    assert int(stats.length) == 2


def test_stats_capacity_clamp():
    """Row pointer clamps at capacity instead of overflowing
    (fixed-capacity replacement for the reference's growing vectors)."""
    stats = stats_init(3, jnp.float64)
    for i in range(6):
        stats = stats_log(stats, cost=float(i))
        stats = stats_new_iteration(stats)
    assert int(stats.length) == 2  # capacity-1
    assert float(np.asarray(stats.rows)[2, 0]) == 5.0


# ------------------------------------------------------------ SOC at scale
def test_soc_constraint_batched_vmap():
    """Second-order-cone constraint through a BATCH of AL solves (vmap path;
    the batch-native solver intentionally gates SOC out)."""
    from altro_jax import ALSolver, Constraint, ProblemParams, SolverStatus
    from altro_jax.models.problems import UnicycleProblem
    from altro_jax.problem.constraints import Cone

    B = 4
    defn = UnicycleProblem()
    defn.N = 40
    defn.__post_init__()
    builder = defn.make_problem(add_constraints=False)

    def soc_fn(params, x, u):
        del x
        return jnp.stack([u[0], params["vmax"]])

    builder.set_constraint(
        Constraint(
            params={"vmax": jnp.asarray(0.8)},
            fn=soc_fn,
            cone=Cone.SECOND_ORDER,
            dim=2,
            label="Velocity SOC",
        ),
        range(defn.N),
    )
    prob = builder.compile()
    solver = ALSolver(prob, SolverOptions())
    rng = np.random.default_rng(0)
    x0s = jnp.asarray(rng.uniform(-0.1, 0.1, size=(B, 3)))
    Z0 = defn.initial_trajectory()
    Zb = jax.tree_util.tree_map(
        lambda l: jnp.broadcast_to(l, (B,) + l.shape), Z0
    )
    axes = ProblemParams(x0=0, dynamics=None, costs=None, constraints=None)
    res = jax.vmap(solver.solve, in_axes=(axes, 0, None))(
        prob.params.replace(x0=x0s), Zb, None
    )
    assert np.all(np.asarray(res.status) == SolverStatus.SOLVED)
    U = np.asarray(res.Z.U)
    assert np.abs(U[:, :, 0]).max() <= 0.8 + 1e-3
    assert np.asarray(res.stats.violations).max() < 1e-4
