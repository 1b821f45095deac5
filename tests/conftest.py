"""Test configuration: CPU backend with a virtual 8-device mesh, float64.

Golden-value parity tests against the reference's Altro.jl-derived numbers
(`test/ilqr/ilqr_test.cpp:196-204` etc.) need float64; sharding tests need
multiple devices, which we emulate on CPU.  The Pallas kernels run in
interpret mode here (`ops/forward_pallas.kernel_interpret`).

GPU-marked tests (`@pytest.mark.gpu`, tests/test_gpu_compiled.py) need the
real card: with ALTRO_GPU_TESTS=1 this file leaves the backend alone and
those tests run; otherwise they skip.  On the GPU host:
    ALTRO_GPU_TESTS=1 python -m pytest -m gpu tests/test_gpu_compiled.py -q
(`chip_smoke.py` runs the same tests in its own process.)

ORDER-DEPENDENT QUADROTOR FAILURE — ROOT CAUSE (r4).  test_quadrotor_waypoint
twice failed in full-suite runs (NaN gains, STATE_LIMIT) while passing in
isolation.  Mechanism, established by perf/quadrotor_path_stability.py:
  (1) the n=13 solve lives in the Cholesky-retry regime (final reg ~0.9);
  (2) there its ITERATION PATH amplifies sub-ulp numeric differences —
      a codegen-only XLA flag flips the solve 19 -> 16 iterations with a
      different endpoint, while 1e-13..1e-6 input perturbations never flip
      the outcome (30/30 SOLVED);
  (3) pre-r4, a finite-but-numerically-singular regularized Quu passed the
      NaN-only Cholesky failure check and emitted unbounded gains, so on an
      unlucky numeric path every line-search rollout tripped the ‖x‖>1e8
      divergence guard and the solve hard-aborted with STATE_LIMIT — the
      exact failing signature.
Fixed by SolverOptions.bp_gain_limit: gains beyond the rollout guard's own
scale count as backward-pass failure in every sweep implementation, so the
unlucky path retries with increased regularization instead of aborting.
"""
import os

# ALTRO_GPU_TESTS=1 leaves the real backend in place for the GPU-marked
# tests (see the module docstring)
_GPU_MODE = os.environ.get("ALTRO_GPU_TESTS", "") == "1"

flags = os.environ.get("XLA_FLAGS", "")
if not _GPU_MODE and "xla_force_host_platform_device_count" not in flags:
    flags = (flags + " --xla_force_host_platform_device_count=8").strip()
# XLA:CPU contracts a*b+c into FMAs wherever fusion leaves them adjacent, so
# two programs with the same per-element arithmetic (a kernel in interpret
# mode and its lax.scan oracle) round differently, and the closed-loop
# equivalence tests amplify that 1 ulp through the feedback gains.  Capping
# the ISA at AVX (no FMA3) makes every op round as written.
if not _GPU_MODE and "xla_cpu_max_isa" not in flags:
    flags = (flags + " --xla_cpu_max_isa=AVX").strip()
os.environ["XLA_FLAGS"] = flags
if not _GPU_MODE:
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

if not _GPU_MODE:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402


@pytest.fixture(scope="session")
def cpu_devices():
    return jax.devices()


@pytest.fixture(scope="session")
def gpu():
    """Skip unless JAX runs on a GPU (decided here, not at import, so every
    xdist worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run with ALTRO_GPU_TESTS=1 on the GPU host")


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Bound the process's accumulated XLA state.

    The suite compiles several hundred programs, some large (B=1024
    interpret-mode Pallas solves); without clearing, the single-process run
    aborts inside XLA's CPU compiler near the end of the suite (SIGABRT in
    backend_compile_and_load, observed r3).  Dropping compiled executables
    between modules keeps peak memory flat; modules re-compile what they
    share (cached fixtures within a module are unaffected).
    """
    yield
    jax.clear_caches()


# `-m quick` (r5): fast golden-parity subset for CI triage — the full
# suite is compile-heavy (>10 min on a 2-core host).  The subset is the
# reference-golden core: AL/iLQR parity, problem layer, cones, riccati.
_QUICK_MODULES = {
    "test_al.py",
    "test_ilqr.py",
    "test_problem_layer.py",
    "test_cones.py",
    "test_riccati.py",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        if item.fspath.basename in _QUICK_MODULES:
            item.add_marker(pytest.mark.quick)
