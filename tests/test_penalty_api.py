"""Per-constraint penalty/dual get-set API (`al_cost.hpp:171-231` analog).

Round-2 gap: only the global `set_penalty` existed; the reference exposes
per-constraint penalty access.  The API addresses constraint families by
index or label and optionally single knot points.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from altro_jax import ALSolver, SolverOptions, SolverStatus
from altro_jax.models.problems import UnicycleProblem


@pytest.fixture(scope="module")
def solver():
    defn = UnicycleProblem()
    prob = defn.make_problem(add_constraints=True).compile()
    return defn, ALSolver(prob, SolverOptions())


def test_get_set_penalty_by_label_and_index(solver):
    _, s = solver
    al = s.init_al_state(jnp.float64)
    labels = [f.label for f in s.prob.constraint_families]
    assert "Control Bound" in labels and "Goal Constraint" in labels

    al2 = s.fns.set_penalty(al, 25.0, family="Control Bound")
    np.testing.assert_allclose(s.fns.get_penalty(al2, "Control Bound"), 25.0)
    # the other family is untouched
    np.testing.assert_allclose(s.fns.get_penalty(al2, "Goal Constraint"), 1.0)
    # index addressing agrees with label addressing
    i = labels.index("Control Bound")
    np.testing.assert_allclose(np.asarray(s.fns.get_penalty(al2, i)), 25.0)


def test_set_penalty_single_knot(solver):
    _, s = solver
    al = s.init_al_state(jnp.float64)
    al2 = s.fns.set_penalty(al, 7.0, family="Control Bound", knot=3)
    rho = np.asarray(s.fns.get_penalty(al2, "Control Bound"))
    assert float(s.fns.get_penalty(al2, "Control Bound", knot=3)) == 7.0
    assert (rho == 1.0).sum() == rho.size - 1  # only one knot changed


def test_get_duals_shape_and_knot(solver):
    defn, s = solver
    al = s.init_al_state(jnp.float64)
    lam = s.fns.get_duals(al, "Goal Constraint")
    assert lam.shape == (1, 3)
    lam_k = s.fns.get_duals(al, "Goal Constraint", knot=defn.N)
    assert lam_k.shape == (3,)


def test_penalty_api_errors(solver):
    _, s = solver
    al = s.init_al_state(jnp.float64)
    with pytest.raises(KeyError):
        s.fns.get_penalty(al, "No Such Constraint")
    with pytest.raises(IndexError):
        s.fns.get_penalty(al, 99)
    with pytest.raises(IndexError):
        # Goal Constraint only exists at the terminal knot
        s.fns.get_penalty(al, "Goal Constraint", knot=0)
    with pytest.raises(ValueError):
        s.fns.set_penalty(al, 1.0, knot=3)


def test_warm_start_with_custom_penalties_solves(solver):
    """A warm al state with per-family penalties still drives the solve
    (`initial_penalty=0` keeps user-set penalties, `al_solver.hpp:295-297`)."""
    defn, s = solver
    prob = s.prob
    al = s.init_al_state(jnp.float64)
    al = s.fns.set_penalty(al, 50.0, family="Goal Constraint")
    opts = SolverOptions(initial_penalty=0.0, reset_duals=False)
    solver2 = ALSolver(prob, opts)
    res = solver2.solve(prob.params, defn.initial_trajectory(), al)
    assert int(res.status) == int(SolverStatus.SOLVED)
    np.testing.assert_allclose(
        float(res.stats.cost), 0.03893465058924039, rtol=1e-3
    )
