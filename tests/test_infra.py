"""Infrastructure tests: logger, profiler, benchmarking, checkpointing.

Parity model: `test/common/timer_test.cpp`, `solver_logging_test.cpp`,
`test/utils/benchmarking_test.cpp`; checkpointing is this framework's
extension of the reference's in-memory warm-start workflow (SURVEY §5).
"""
import io
import time
from contextlib import redirect_stdout

import jax.numpy as jnp
import numpy as np

from altro_jax import ALSolver, LogLevel, SolverOptions, SolverStatus
from altro_jax.models.problems import UnicycleProblem
from altro_jax.utils.benchmarking import benchmark
from altro_jax.utils.checkpoint import load_pytree, save_pytree
from altro_jax.utils.logging import SolverLogger
from altro_jax.utils.timer import Timer


def test_python_timer_hierarchy():
    t = Timer(active=True)
    with t.scope("al"):
        with t.scope("ilqr"):
            time.sleep(0.005)
    assert t.get_us("al/ilqr") >= 4_000
    assert t.get_us("al") >= t.get_us("al/ilqr")
    s = t.summary()
    assert "ilqr" in s and "%total" in s
    t2 = Timer(active=False)
    with t2.scope("x"):
        pass
    assert t2.get_us("x") == 0.0


def test_benchmark_util():
    res = benchmark(lambda: sum(range(1000)), samples=5, warmup=1, block=False)
    assert res.min <= res.median <= res.max
    assert len(res.samples_ms) == 5


def test_logger_levels_and_rows():
    logger = SolverLogger(LogLevel.INNER, color=False)
    assert logger.active("cost")
    assert not logger.active("reg")  # INNER_DEBUG column hidden at INNER
    buf = io.StringIO()
    with redirect_stdout(buf):
        logger.log("cost", 1.234)
        logger.log("alpha", 0.5)
        logger.print_row()
    out = buf.getvalue()
    assert "1.234" in out and "0.50" in out


def test_solver_verbose_summary_prints():
    defn = UnicycleProblem()
    prob = defn.make_problem(add_constraints=True).compile()
    solver = ALSolver(prob, SolverOptions(verbose=LogLevel.INNER_DEBUG))
    buf = io.StringIO()
    with redirect_stdout(buf):
        res = solver.solve(prob.params, defn.initial_trajectory())
    out = buf.getvalue()
    assert "cost" in out and "viol" in out
    assert "status: SOLVED" in out
    # one row per inner iteration
    assert len([l for l in out.splitlines() if l and l[0] == " "]) >= int(
        res.stats.iterations_total
    )


def test_checkpoint_roundtrip(tmp_path):
    defn = UnicycleProblem()
    prob = defn.make_problem(add_constraints=True).compile()
    solver = ALSolver(prob, SolverOptions())
    res = solver.solve(prob.params, defn.initial_trajectory())
    path = tmp_path / "state.npz"
    save_pytree(path, (res.Z, res.al))
    Z2, al2 = load_pytree(path, (res.Z, res.al))
    np.testing.assert_array_equal(Z2.U, res.Z.U)
    np.testing.assert_array_equal(al2[0].lam, res.al[0].lam)
    # resume: warm-started solve from the checkpoint converges immediately to
    # the same optimum (a re-solve re-runs the AL loop, so equality is to
    # solver tolerance, not bitwise)
    res2 = solver.solve(prob.params, Z2, al2)
    assert int(res2.status) == int(SolverStatus.SOLVED)
    np.testing.assert_allclose(res2.Z.U, res.Z.U, atol=1e-4)
    assert int(res2.stats.iterations_total) <= int(res.stats.iterations_total)


def test_constraint_info_and_print(capsys):
    """Constraint introspection (`al_solver.hpp:68-104` analog)."""
    defn = UnicycleProblem()
    prob = defn.make_problem(add_constraints=True).compile()
    solver = ALSolver(prob, SolverOptions())
    Z = solver.ilqr.rollout(prob.params, defn.initial_trajectory())
    assert solver.num_constraints() == defn.N * 4 + 3  # bounds 4/knot + goal
    assert solver.num_constraints(0) == 4
    assert solver.num_constraints(defn.N) == 3
    info = solver.constraint_info(prob.params, Z, sort=True)
    assert len(info) == defn.N + 1
    # sorted: worst first — the unmet goal dominates on the initial rollout
    assert info[0]["label"] == "Goal Constraint"
    assert info[0]["violation"].max() > info[-1]["violation"].max()
    solver.print_violations(prob.params, Z)
    out = capsys.readouterr().out
    assert f"Got {defn.N + 1} constraints" in out
    assert "Control Bound" in out and "Goal Constraint" in out
