"""Fused expansion+Riccati backward kernel vs the expand+scan oracle.

`ops/backward_fused_pallas.py` computes the quadratic-cost expansion, the
AL Gauss-Newton terms, and the RK4 discrete Jacobians inside the backward
sweep (VERDICT r3 perf ask: the expand phase was the remaining multi-kernel
XLA stage).  Interpret mode on CPU, f64, so equality to the oracle is
algorithmic (~1e-11), not rounding-limited.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from altro_jax import SolverOptions, SolverStatus
from altro_jax.models.problems import TripleIntegratorProblem, UnicycleProblem
from altro_jax.ops.backward_fused_pallas import build_backward_fused_kernel
from altro_jax.solver.batched import ALSolverBatched, to_batch_last

TILE = 1024


def _setup(defn, constrained=True, seed=0, spread=0.3):
    prob = defn.make_problem(add_constraints=constrained).compile()
    fast = ALSolverBatched(prob, SolverOptions())
    Z0 = defn.initial_trajectory()
    rng = np.random.default_rng(seed)
    x0s = jnp.asarray(rng.uniform(-spread, spread, (defn.n, TILE)))
    params = prob.params.replace(x0=x0s)
    Zb = to_batch_last(
        jax.tree_util.tree_map(
            lambda l: jnp.broadcast_to(l, (TILE,) + l.shape), Z0
        )
    )
    Zb = fast.rollout(params, Zb)
    al = tuple(
        dict(
            lam=jnp.asarray(rng.uniform(-0.5, 0.0, st["lam"].shape)),
            rho=jnp.asarray(rng.uniform(1.0, 10.0, st["rho"].shape)),
        )
        for st in fast.al_state_init(TILE, jnp.float64)
    )
    kern = build_backward_fused_kernel(
        prob, SolverOptions(), interpret=True, dtype=jnp.float64
    )
    assert kern is not None
    return fast, prob, params, al, Zb, kern


@pytest.fixture(scope="module")
def unicycle():
    defn = UnicycleProblem(dtype=jnp.float64)
    defn.N = 12
    defn.__post_init__()
    return _setup(defn)


def _oracle(fast, params, al, Zb, rho):
    exp = fast.expand(params, al, Zb)
    K, d, dV1, dV2, failed = fast.riccati_scan(exp, rho)
    J0 = fast.total_cost(params, al, Zb)
    return K, d, dV1, dV2, failed, J0


def test_fused_matches_expand_plus_scan(unicycle):
    fast, prob, params, al, Zb, kern = unicycle
    rho = jnp.zeros((TILE,))
    K0, d0, dV10, dV20, f0, J0r = _oracle(fast, params, al, Zb, rho)
    K1, d1, dV11, dV21, f1, J01 = kern(params, kern.pad_al(al), Zb, rho)
    np.testing.assert_allclose(K1, K0, rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(d1, d0, rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(dV11, dV10, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(dV21, dV20, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(J01, J0r, rtol=1e-10)
    np.testing.assert_array_equal(np.asarray(f1), np.asarray(f0))


def test_fused_matches_with_regularization(unicycle):
    fast, prob, params, al, Zb, kern = unicycle
    rho = jnp.full((TILE,), 0.37)
    K0, d0, *_ = _oracle(fast, params, al, Zb, rho)
    K1, d1, *_ = kern(params, kern.pad_al(al), Zb, rho)
    np.testing.assert_allclose(K1, K0, rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(d1, d0, rtol=1e-9, atol=1e-10)


def _lanes(params, al, Zb, width):
    """The first `width` lanes of a fleet."""
    sub = lambda a: a[..., :width]
    return (
        params.replace(x0=sub(params.x0)),
        tuple(dict(lam=sub(s["lam"]), rho=sub(s["rho"])) for s in al),
        Zb.replace(X=sub(Zb.X), U=sub(Zb.U)),
    )


@pytest.mark.parametrize("width", [5, 37])
def test_fused_odd_width_pads_lanes(unicycle, width):
    """A width that is not a multiple of the lanes per program runs on
    padded lanes (copies of the last one) and is sliced back: every output
    keeps the fleet's width and matches the oracle lane for lane."""
    fast, prob, params, al, Zb, kern = unicycle
    assert width % kern.block_for(width)
    p, a, Z = _lanes(params, al, Zb, width)
    rho = jnp.full((width,), 0.1)
    want = _oracle(fast, p, a, Z, rho)
    got = kern(p, kern.pad_al(a), Z, rho)
    for name, g, w in zip(("K", "d", "dV1", "dV2", "failed", "J0"), got, want):
        assert g.shape == w.shape, name
        if name == "failed":
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
        else:
            np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-10, err_msg=name)


def test_fused_full_solve_identical_path(unicycle):
    """Whole batched AL solve with backward_pass='fused': identical
    iteration path and solution vs the scan-config solve."""
    fast, prob, params, al, Zb, kern = unicycle
    r0 = jax.jit(fast.solve)(params, Zb)
    fused = ALSolverBatched(prob, SolverOptions(backward_pass="fused"))
    assert fused._bwd is not None
    r1 = jax.jit(fused.solve)(params, Zb)
    np.testing.assert_array_equal(
        np.asarray(r0["status"]), np.asarray(r1["status"])
    )
    np.testing.assert_array_equal(
        np.asarray(r0["stats"].iterations_total),
        np.asarray(r1["stats"].iterations_total),
    )
    np.testing.assert_allclose(r1["Z"].U, r0["Z"].U, rtol=1e-8, atol=1e-9)
    assert np.all(np.asarray(r1["status"]) == int(SolverStatus.SOLVED))


def test_fused_obstacle_scenario():
    """Three-obstacle scenario exercises the circle-constraint Gauss-Newton
    rows (off-diagonal Hxx terms) and a non-full knot range (k ∈ [1, N))."""
    defn = UnicycleProblem(scenario="three_obstacles", dtype=jnp.float64)
    defn.N = 10
    defn.__post_init__()
    fast, prob, params, al, Zb, kern = _setup(defn, seed=3, spread=0.1)
    rho = jnp.zeros((TILE,))
    K0, d0, dV10, _, f0, J0r = _oracle(fast, params, al, Zb, rho)
    K1, d1, dV11, _, f1, J01 = kern(params, kern.pad_al(al), Zb, rho)
    np.testing.assert_allclose(K1, K0, rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(d1, d0, rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(J01, J0r, rtol=1e-10)


def test_fused_linear_dynamics_euler_ineligible_paths():
    """Triple integrator (linear dynamics): fused kernel still exact; and
    an opaque-constraint problem is ineligible -> build returns None."""
    defn = TripleIntegratorProblem(dof=2, N=8, dtype=jnp.float64)
    fast, prob, params, al, Zb, kern = _setup(defn, constrained=True, spread=0.2)
    rho = jnp.zeros((TILE,))
    K0, d0, *_ , J0r = _oracle(fast, params, al, Zb, rho)
    K1, d1, *_, J01 = kern(params, kern.pad_al(al), Zb, rho)
    np.testing.assert_allclose(K1, K0, rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(J01, J0r, rtol=1e-10)

    # opaque constraint -> ineligible
    from altro_jax import Cone, Constraint

    defn2 = UnicycleProblem(dtype=jnp.float64)
    builder = defn2.make_problem(add_constraints=False)
    soc = Constraint(
        params={"vmax": jnp.asarray(0.8)},
        fn=lambda p, x, u: jnp.stack([u[0], p["vmax"]]),
        cone=Cone.SECOND_ORDER,
        dim=2,
    )
    builder.set_constraint(soc, range(defn2.N))
    prob2 = builder.compile()
    assert build_backward_fused_kernel(prob2, SolverOptions()) is None
    # and the solver still solves it through the fallback path
    fb = ALSolverBatched(prob2, SolverOptions(backward_pass="fused"))
    assert fb._bwd is None
