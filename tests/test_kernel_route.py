"""How the Pallas kernels reach each platform, checked on the CPU.

  * both kernels lower to a Triton custom call for CUDA (parking n=3 and
    quadrotor n=13) — the GPU compile path, without a GPU;
  * the route rule: compiled on "gpu", interpreted on "cpu", an error on
    any other platform (no silent interpret mode on an accelerator);
  * lanes per program on the GPU, and the padding of other widths;
  * the persistent compile cache helper honours JAX_COMPILATION_CACHE_DIR;
  * backward_pass="fused" on a kernel-ineligible problem falls back to
    `riccati_scan`, with the same sweep results.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from altro_jax import SolverOptions  # noqa: E402
from altro_jax.models.problems import QuadrotorProblem, UnicycleProblem  # noqa: E402
from altro_jax.ops.backward_fused_pallas import build_backward_fused_kernel  # noqa: E402
from altro_jax.ops.forward_pallas import build_forward_kernel, kernel_interpret  # noqa: E402
from altro_jax.solver.batched import ALSolverBatched, to_batch_last  # noqa: E402
from altro_jax.utils import cache  # noqa: E402
from perf.verify_kernels import TRITON_CALL  # noqa: E402

B = 64


def _fleet(defn, dtype=jnp.float32):
    prob = defn.make_problem(add_constraints=True).compile()
    x0 = jnp.broadcast_to(jnp.asarray(defn.x0, dtype)[:, None], (prob.n, B))
    # model params default to f64 under the suite's x64 mode
    params = jax.tree_util.tree_map(
        lambda l: jnp.asarray(l, dtype), prob.params.replace(x0=x0)
    )
    Z0 = defn.initial_trajectory()
    Zb = to_batch_last(
        jax.tree_util.tree_map(
            lambda l: jnp.broadcast_to(jnp.asarray(l, dtype), (B,) + l.shape), Z0
        )
    )
    return prob, params, Zb


def _problem(name):
    if name == "parking":
        defn = UnicycleProblem(dtype=jnp.float32)
        defn.N = 8
    else:
        defn = QuadrotorProblem(N=4)
    defn.__post_init__()
    return defn


@pytest.mark.parametrize("kernel", ["forward", "backward"])
@pytest.mark.parametrize("problem", ["parking", "quadrotor"])
def test_kernel_lowers_to_triton_for_cuda(problem, kernel):
    """Each kernel lowers to a Triton call for CUDA.  The quadrotor's state
    (n=13) is wider than the fused backward kernel takes
    (`BackwardFusedKernel.max_state_dim`), so its backward pass lowers to
    the scan sweep with no Triton call."""
    defn = _problem(problem)
    prob, params, Zb = _fleet(defn)
    opts = SolverOptions()
    al = ALSolverBatched(prob, opts).al_state_init(B, jnp.float32)
    if problem == "quadrotor" and kernel == "backward":
        assert build_backward_fused_kernel(prob, opts, interpret=False) is None
        fused = ALSolverBatched(prob, SolverOptions(backward_pass="fused"))
        assert fused._bwd is None
        zero = jnp.zeros((B,), jnp.float32)
        text = jax.jit(
            lambda p, a, Z: fused.backward_pass(fused.expand(p, a, Z), zero, zero)
        ).trace(params, al, Zb).lower(lowering_platforms=("cuda",)).as_text()
        assert TRITON_CALL not in text
        return
    if kernel == "forward":
        kern = build_forward_kernel(prob, opts, interpret=False)
        zK = jnp.zeros((prob.N, prob.m, prob.n, B), jnp.float32)
        zd = jnp.zeros((prob.N, prob.m, B), jnp.float32)

        def fn(p, a, Z):
            return kern(p, kern.pad_al(a), Z, zK, zd, 1.0)
    else:
        kern = build_backward_fused_kernel(prob, opts, interpret=False)

        def fn(p, a, Z):
            return kern(p, kern.pad_al(a), Z, jnp.zeros((B,), jnp.float32))

    assert kern is not None
    text = jax.jit(fn).trace(params, al, Zb).lower(
        lowering_platforms=("cuda",)
    ).as_text()
    assert TRITON_CALL in text


@pytest.mark.parametrize(
    "kernel,width,block",
    [
        ("forward", 4096, 128),
        ("forward", 4000, 128),
        ("forward", 100, 128),
        ("forward", 1, 32),
        ("backward", 4000, 64),
        ("backward", 40, 64),
    ],
)
def test_gpu_lanes_per_program(kernel, width, block):
    """On the GPU a program is the kernel's block of lanes, or the smallest
    power of two covering a narrower fleet, and never less than one warp;
    the padded width is a whole number of programs."""
    prob, params, Zb = _fleet(_problem("parking"))
    build = build_forward_kernel if kernel == "forward" else build_backward_fused_kernel
    kern = build(prob, SolverOptions(), interpret=False)
    assert kern.block_for(width) == block
    x0 = jnp.zeros((prob.n, width), jnp.float32)
    arrays = [x0] * len(kern._input_layout(frozenset())[1])
    padded, Bp = kern._pad_lanes(arrays, frozenset(), width)
    assert Bp % block == 0 and 0 <= Bp - width < block


@pytest.mark.parametrize("dof,eligible", [(2, True), (3, False)])
def test_fused_backward_state_width_cutoff(dof, eligible):
    """The fused backward kernel takes the triple integrator at n=6 and
    refuses it at n=9 (`BackwardFusedKernel.max_state_dim`); the forward
    kernel takes both."""
    from altro_jax.models.problems import TripleIntegratorProblem

    defn = TripleIntegratorProblem(dof=dof, N=4, dtype=jnp.float32)
    prob = defn.make_problem(add_constraints=True).compile()
    opts = SolverOptions()
    kern = build_backward_fused_kernel(prob, opts, interpret=False)
    assert (kern is not None) is eligible
    assert build_forward_kernel(prob, opts, interpret=False) is not None


@pytest.mark.parametrize("backend,interpret", [("cpu", True), ("gpu", False)])
def test_kernel_route_by_backend(backend, interpret):
    assert kernel_interpret(backend) is interpret


@pytest.mark.parametrize("backend", ["rocm", "metal"])
def test_kernel_route_refuses_other_platforms(backend):
    with pytest.raises(ValueError, match="neither route"):
        kernel_interpret(backend)


def test_solver_with_kernels_refuses_platform_without_route(monkeypatch):
    """A kernel option on a platform without a route is an error at solver
    construction, not a silent interpret-mode run; the scan config is
    unaffected."""
    defn = _problem("parking")
    prob = defn.make_problem(add_constraints=True).compile()
    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    with pytest.raises(ValueError, match="neither route"):
        ALSolverBatched(prob, SolverOptions(forward_pass="pallas"))
    with pytest.raises(ValueError, match="neither route"):
        ALSolverBatched(prob, SolverOptions(backward_pass="fused"))
    assert ALSolverBatched(prob, SolverOptions())._fwd is None


def test_cache_helper_defers_to_env(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    assert cache.enable_compilation_cache() is None
    assert calls == []


def test_cache_helper_uses_checkout_dir(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = cache.enable_compilation_cache()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(repo, ".jax_cache")
    assert ("jax_compilation_cache_dir", path) in calls


@pytest.fixture(scope="module")
def ineligible():
    """Unicycle with a non-quadratic stage cost: no fused kernel, so
    backward_pass="fused" runs the scan sweep."""
    from altro_jax.problem.costs import Cost

    defn = UnicycleProblem(dtype=jnp.float64)
    defn.N = 12
    defn.__post_init__()
    problem = defn.make_problem(add_constraints=True)
    problem.set_cost(
        Cost(fn=lambda p, x, u: 0.5 * jnp.sum(x**2) + 0.1 * jnp.sum(u**4),
             params={}),
        range(defn.N),
    )
    prob = problem.compile()
    fused = ALSolverBatched(prob, SolverOptions(backward_pass="fused"))
    assert fused._bwd is None
    assert build_backward_fused_kernel(prob, SolverOptions()) is None
    scan = ALSolverBatched(prob, SolverOptions())
    rng = np.random.default_rng(0)
    params = prob.params.replace(x0=jnp.asarray(rng.uniform(-0.3, 0.3, (3, B))))
    Z0 = defn.initial_trajectory()
    Zb = to_batch_last(
        jax.tree_util.tree_map(lambda l: jnp.broadcast_to(l, (B,) + l.shape), Z0)
    )
    Zb = scan.rollout(params, Zb)
    exp = scan.expand(params, scan.al_state_init(B, jnp.float64), Zb)
    return fused, scan, exp


@pytest.mark.parametrize("case", ["no_reg", "reg", "not_pd"])
def test_fused_fallback_backward_is_riccati_scan(ineligible, case):
    """The cases the retired Riccati Pallas kernel was checked on, now on
    the fallback: the retry loop around `riccati_scan` gives the same gains,
    expected-decrease terms and failure flags as the scan config."""
    fused, scan, exp = ineligible
    rho = jnp.full((B,), 0.37 if case == "reg" else 0.0)
    if case == "not_pd":
        # negative-definite luu at one knot: every lane fails at rho = 0
        exp = dict(exp)
        exp["luu"] = exp["luu"].at[3].set(
            jnp.broadcast_to(
                jnp.diag(jnp.array([-1.0, -1.0]))[:, :, None],
                exp["luu"].shape[1:],
            )
        )
        *_, failed = scan.riccati_scan(exp, rho)
        assert bool(jnp.all(failed))
    drho = jnp.zeros((B,))
    out_f = fused.backward_pass(exp, rho, drho)
    out_s = scan.backward_pass(exp, rho, drho)
    for key in ("K", "d", "dV1", "dV2", "failed", "rho"):
        np.testing.assert_array_equal(
            np.asarray(out_f[key]), np.asarray(out_s[key]), err_msg=key
        )
