"""Live-solve observability: wired profiler + live iteration logging.

Reference behavior being mirrored: `profiler_enable` activates a hierarchical
phase profiler during `Solve()` (`al_solver.hpp:307-309`, Stopwatch scopes at
`ilqr/ilqr.hpp:294,351,386,469,513,569,598,630`), optionally written to
`log_directory/profile_filename` (`solver_stats.cpp:68-78`); non-silent
`verbose` prints the iteration table DURING the solve with headers reprinted
every `header_frequency` rows (`solver_logger.cpp:47-54`,
`al_solver.hpp:318-331`).
"""
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest

from altro_jax import ALSolver, SolverOptions, SolverStatus
from altro_jax.models.problems import TripleIntegratorProblem, UnicycleProblem
from altro_jax.options import LogLevel


@pytest.fixture(scope="module")
def tri_constrained():
    defn = TripleIntegratorProblem(dof=2)
    prob = defn.make_problem(add_constraints=True).compile()
    return defn, prob


def _solve(prob, defn, opts):
    return ALSolver(prob, opts).solve(prob.params, defn.initial_trajectory())


def test_instrumented_matches_fused(tri_constrained):
    """The host-stepped observability path must follow the exact iteration
    path of the fused while_loop solver."""
    defn, prob = tri_constrained
    res_f = _solve(prob, defn, SolverOptions())
    res_i = _solve(prob, defn, SolverOptions(profiler_enable=True))
    assert int(res_i.status) == int(res_f.status) == SolverStatus.SOLVED
    assert int(res_i.stats.iterations_total) == int(res_f.stats.iterations_total)
    assert int(res_i.stats.iterations_outer) == int(res_f.stats.iterations_outer)
    np.testing.assert_allclose(res_i.stats.cost, res_f.stats.cost, rtol=1e-12)
    np.testing.assert_allclose(res_i.Z.U, res_f.Z.U, atol=1e-10)
    np.testing.assert_allclose(
        res_i.stats.violations, res_f.stats.violations, atol=1e-12
    )


def test_instrumented_matches_fused_unicycle():
    """Same check on the canonical unicycle golden problem
    (`auglag_test.cpp:325-351`: 14 total / 5 outer iterations)."""
    defn = UnicycleProblem()
    prob = defn.make_problem(add_constraints=True).compile()
    opts = SolverOptions(constraint_tolerance=1e-6)
    res_i = _solve(prob, defn, opts.replace(profiler_enable=True))
    assert int(res_i.status) == SolverStatus.SOLVED
    assert int(res_i.stats.iterations_total) == 14
    assert int(res_i.stats.iterations_outer) == 5
    np.testing.assert_allclose(
        float(res_i.stats.cost), 0.03893465058924039, rtol=1e-6
    )


def test_profiler_scopes_recorded(tri_constrained):
    """Phase scopes accumulate real time under profiler_enable
    (`ilqr.hpp:294,351,386,513`)."""
    defn, prob = tri_constrained
    solver = ALSolver(prob, SolverOptions(profiler_enable=True))
    solver.solve(prob.params, defn.initial_trajectory())
    timer = solver.timer
    assert timer is not None and timer.active
    for key in (
        "al",
        "al/init",
        "al/ilqr",
        "al/ilqr/expansions",
        "al/ilqr/backward_pass",
        "al/ilqr/forward_pass",
        "al/dual_update",
        "al/penalty_update",
        "al/convergence_check",
    ):
        assert timer.get_us(key) > 0.0, key
    # phases nest inside the root scope
    assert timer.get_us("al") > timer.get_us("al/ilqr") > 0.0


def test_profiler_disabled_records_nothing(tri_constrained):
    defn, prob = tri_constrained
    solver = ALSolver(prob, SolverOptions())
    solver.solve(prob.params, defn.initial_trajectory())
    assert solver.timer is None


def test_profiler_output_to_file(tri_constrained, tmp_path):
    """`profiler_output_to_file` + `log_directory` + `profile_filename`
    write the summary tree (`solver_stats.cpp:68-78`)."""
    defn, prob = tri_constrained
    logdir = tmp_path / "logs"
    opts = SolverOptions(
        profiler_enable=True,
        profiler_output_to_file=True,
        log_directory=str(logdir),
        profile_filename="profile_tri.out",
    )
    ALSolver(prob, opts).solve(prob.params, defn.initial_trajectory())
    path = logdir / "profile_tri.out"
    assert path.exists()
    text = path.read_text()
    # summary format of perf/profiler_unicycle.out: tree + %total/%parent
    assert "%total" in text and "%parent" in text
    assert re.search(r"^al\b", text, re.M)
    assert "backward_pass" in text and "forward_pass" in text


def test_live_rows_and_header_frequency(tri_constrained, capsys):
    """Non-silent verbose prints one row per inner iteration live, with the
    header reprinted every `header_frequency` rows."""
    defn, prob = tri_constrained
    opts = SolverOptions(verbose=LogLevel.INNER_DEBUG, header_frequency=2)
    res = _solve(prob, defn, opts)
    outp = capsys.readouterr().out
    lines = [
        l for l in outp.splitlines() if l.strip() and not l.startswith("status:")
    ]
    headers = [l for l in lines if "cost" in l and "dJ" in l]
    total = int(res.stats.iterations_total)
    outer = int(res.stats.iterations_outer)
    # one row per inner iteration + one per outer iteration
    data_rows = [
        l for l in lines if l not in headers and not set(l.strip()) <= {"-"}
    ]
    assert len(data_rows) == total + outer
    # header every 2 rows
    assert len(headers) >= (total + outer) // 2


def test_verbose_outer_hides_inner_columns(tri_constrained, capsys):
    """Column x verbosity matrix: at OUTER only OUTER-level columns render
    (`log_entry.hpp:27-34`, `solver_stats.cpp:80-114`)."""
    defn, prob = tri_constrained
    res = _solve(prob, defn, SolverOptions(verbose=LogLevel.OUTER))
    outp = capsys.readouterr().out
    assert "iter_al" in outp and "viol" in outp
    # INNER/INNER_DEBUG columns absent
    assert "dJ" not in outp and "reg" not in outp and "alpha" not in outp
    lines = [
        l for l in outp.splitlines() if l.strip() and not l.startswith("status:")
    ]
    headers = [l for l in lines if "iter_al" in l]
    rows = [l for l in lines if l not in headers and not set(l.strip()) <= {"-"}]
    assert len(rows) == int(res.stats.iterations_outer)


def test_header_frequency_option_not_dead(tri_constrained, capsys):
    """header_frequency=1 reprints the header before every row."""
    defn, prob = tri_constrained
    _solve(
        prob, defn, SolverOptions(verbose=LogLevel.OUTER, header_frequency=1)
    )
    outp = capsys.readouterr().out
    lines = [
        l for l in outp.splitlines() if l.strip() and not l.startswith("status:")
    ]
    headers = [l for l in lines if "iter_al" in l and "viol" in l]
    seps = [l for l in lines if set(l.strip()) <= {"-"}]
    rows = len(lines) - len(headers) - len(seps)
    assert len(headers) == rows


def test_unconstrained_instrumented(capsys):
    """Unconstrained problems route through the plain-iLQR instrumented
    branch (single inner solve, `ilqr` at the profile root)."""
    defn = TripleIntegratorProblem(dof=2)
    prob = defn.make_problem(add_constraints=False).compile()
    solver = ALSolver(prob, SolverOptions(profiler_enable=True))
    res = solver.solve(prob.params, defn.initial_trajectory())
    capsys.readouterr()
    assert int(res.status) == SolverStatus.SOLVED
    # golden: 2 inner iterations (`ilqr_test.cpp:304-311`)
    assert int(res.stats.iterations_total) == 2
    assert solver.timer.get_us("al/ilqr/backward_pass") > 0


def test_traced_solve_stays_fused(tri_constrained):
    """Under jit the observability options must not break tracing."""
    import jax

    defn, prob = tri_constrained
    solver = ALSolver(prob, SolverOptions(profiler_enable=True))
    res = jax.jit(solver.solve)(prob.params, defn.initial_trajectory())
    assert int(res.status) == SolverStatus.SOLVED
    assert solver.timer is None  # instrumented path never engaged
