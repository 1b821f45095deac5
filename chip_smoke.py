#!/usr/bin/env python
"""GPU smoke run: the batched AL-iLQR fleet solve, compiled, on one card.

    python chip_smoke.py          # one GPU: phases 1-4
    python chip_smoke.py --four   # four GPUs: the sharded fleet solve only

Phases (one process, one card):
  1. device   — the card's name and power limit (nvidia-smi), JAX's
                devices, XLA_FLAGS and the JAX version;
  2. kernels  — the compiled Triton kernels against the XLA scan oracles
                (`perf/verify_kernels.py`) on the unicycle parking fleet at
                B=4096 and the quadrotor (n=13, m=4; forward kernel only —
                its state is too wide for the fused backward kernel) at
                B=256, and a Triton custom call asserted in each kernel's
                lowered HLO;
  3. main     — `bench.make_solver` on the parking fleet (B=4096, N=100,
                f32): every lane's status accounted for, >= 99% SOLVED,
                control parity <= 1e-4 at `bench.parity_solve`'s config,
                the kernels' f32 merit at that solve's converged
                multipliers within its rounding bound of the f64 merit,
                and solves/s of the shipped config and of the all-scan
                config (median of 5 solves after warm-up);
  4. tests    — the GPU-marked tests, through `pytest.main` in this
                process.

`--four` shards 4 x 4096 parking lanes over a 1-D mesh of four cards
(`ShardedBatchedALSolver`) and compares every lane with an unsharded solve
of its shard on one card, and the three fleet folds with their host sums.

The last line of standard output is one JSON object,
`{"ok": true, "device": {"platform", "kind", "count"}}`.  Without a GPU, or
when any phase fails, the script exits non-zero and prints no such line.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

_REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _REPO)

BATCH = 4096
QUAD_BATCH = 256
REPS = 5


def card_line() -> str:
    """`name, power.limit` of every visible card, one line each."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def median_wall(solve, *args, reps: int = REPS) -> tuple[float, list]:
    """Median wall time of `reps` solves after one warm-up call."""
    import jax

    jax.block_until_ready(solve(*args)["Z"].U)
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(solve(*args)["Z"].U)
        walls.append(time.perf_counter() - t0)
    return float(np.median(walls)), walls


def phase_device(card: str) -> None:
    import jax

    print(f"[device] card: {card}")
    print(f"[device] jax {jax.__version__} devices: {jax.devices()}")
    print(f"[device] XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")


def phase_kernels() -> None:
    import jax.numpy as jnp

    from altro_jax.models.problems import QuadrotorProblem, UnicycleProblem
    from perf.verify_kernels import verify_compiled_kernels

    # the quadrotor's open-loop hover rollout needs rho=1e3 before every
    # lane's sweep succeeds in f32 (below it the oracle's own gains reach
    # 1e7 and any two rollouts part ways chaotically)
    for name, defn, batch, spread, rho in (
        ("parking", UnicycleProblem(dtype=jnp.float32), BATCH, 0.1, 0.0),
        ("quadrotor", QuadrotorProblem(), QUAD_BATCH, 0.05, 1e3),
    ):
        prob = defn.make_problem(add_constraints=True).compile()
        t0 = time.perf_counter()
        deltas = verify_compiled_kernels(
            prob, defn, batch, spread=spread, rho=rho
        )
        print(
            f"[kernels] {name} n={prob.n} m={prob.m} N={prob.N} B={batch} "
            f"({time.perf_counter() - t0:.1f} s incl. compile): "
            + json.dumps(deltas)
        )


def phase_main(card: str) -> None:
    import jax.numpy as jnp

    import bench
    from altro_jax import SolverStatus
    from altro_jax.models.problems import UnicycleProblem

    defn = UnicycleProblem(dtype=jnp.float32)
    prob = defn.make_problem(add_constraints=True).compile()
    params_b, Zb = bench.make_batch(prob, defn, BATCH, jnp.float32)

    solver = bench.make_solver(prob, BATCH)
    t0 = time.perf_counter()
    res = solver.solve(params_b, Zb)
    status = np.asarray(res["status"])
    print(f"[main] first solve incl. compile: {time.perf_counter() - t0:.1f} s")
    hist = bench.status_histogram(status)
    solved = hist.get(SolverStatus.SOLVED.name, 0)
    print(f"[main] status histogram B={BATCH}: {hist}")
    if sum(hist.values()) != BATCH:
        raise AssertionError(f"statuses unaccounted for: {hist}")
    if solved < 0.99 * BATCH:
        raise AssertionError(f"only {solved}/{BATCH} SOLVED")

    check_parity(prob, defn)

    configs = (
        ("shipped", {}),
        ("all-scan", dict(backward_pass="scan", forward_pass="scan")),
    )
    for name, over in configs:
        s = bench.make_solver(prob, BATCH, **over)
        wall, walls = median_wall(s.solve, params_b, Zb)
        print(
            f"[main] {name} {s.opts.backward_pass}/{s.opts.forward_pass}: "
            f"{BATCH / wall:.1f} solves/s (median {wall * 1e3:.2f} ms of "
            f"{[round(w * 1e3, 2) for w in walls]} ms, B={BATCH}) on {card}"
        )


def check_parity(prob, defn) -> None:
    """Control parity at `bench.parity_solve`'s config, and the kernels' f32
    merit at the converged iterate, multipliers and penalties against the
    same merit in f64 (`perf/verify_kernels.verify_kernel_cost`)."""
    import jax.numpy as jnp

    import bench
    from altro_jax.solver.batched import ALSolverBatched
    from perf.verify_kernels import verify_kernel_cost

    U_ref, X_ref, J_ref = bench.load_reference_golden(
        "unicycle_turn90_refsolve_f64_tol6.npz"
    )
    batch = bench.TAIL_BATCH
    pres, _ = bench.parity_solve(prob, defn, batch)
    U0 = np.asarray(pres["Z"].U[..., 0], np.float64)
    parity = float(np.abs(U0 - U_ref).max())
    J0 = float(np.asarray(pres["stats"].cost[0], np.float64))
    print(
        f"[main] control parity vs f64 reference (ctol 1e-6): {parity:.3e}; "
        f"stats.cost {J0!r} vs reference J {J_ref!r} "
        f"(relative {(J0 - J_ref) / J_ref:.3e})"
    )
    if not parity <= 1e-4:
        raise AssertionError(f"control parity {parity} > 1e-4")
    solver = ALSolverBatched(prob, bench.parity_options())
    params = prob.params.replace(x0=jnp.zeros((prob.n, batch), jnp.float32))
    merit = verify_kernel_cost(solver, params, pres["al"], pres["Z"])
    print(f"[main] f32 merit at the converged iterate vs f64: {json.dumps(merit)}")


def phase_tests() -> None:
    import pytest

    os.environ["ALTRO_GPU_TESTS"] = "1"
    rc = pytest.main(
        ["-q", "-m", "gpu", "-p", "no:cacheprovider",
         os.path.join(_REPO, "tests", "test_gpu_compiled.py")]
    )
    if rc != 0:
        raise AssertionError(f"GPU-marked tests failed (pytest exit {rc})")


def phase_four() -> None:
    """Sharded 4 x 4096-lane fleet vs an unsharded solve per shard."""
    import jax
    import jax.numpy as jnp

    import bench
    from altro_jax import SolverStatus
    from altro_jax.models.problems import UnicycleProblem
    from altro_jax.parallel.mesh import ShardedBatchedALSolver, make_mesh
    from altro_jax.solver.batched import ALSolverBatched

    devices = jax.devices()
    if len(devices) != 4:
        raise AssertionError(f"--four needs 4 GPUs, found {len(devices)}")
    defn = UnicycleProblem(dtype=jnp.float32)
    prob = defn.make_problem(add_constraints=True).compile()
    batch = 4 * BATCH
    params_b, Zb = bench.make_batch(prob, defn, batch, jnp.float32)
    opts = bench.bench_options()
    mesh = make_mesh(devices)
    sh = ShardedBatchedALSolver(prob, mesh, opts)
    t0 = time.perf_counter()
    res, viol_max, n_solved, n_stalled = sh.solve(
        sh.shard_params(params_b), sh.shard_batch(Zb)
    )
    jax.block_until_ready(res["Z"].U)
    print(f"[four] sharded solve incl. compile: {time.perf_counter() - t0:.1f} s")
    status = np.asarray(res["status"])
    U = np.asarray(res["Z"].U)

    ref = jax.jit(ALSolverBatched(prob, opts).solve)
    st_ref, U_ref, viol_ref = [], [], []
    with jax.default_device(devices[0]):
        for i in range(4):
            sl = slice(i * BATCH, (i + 1) * BATCH)
            p_i = params_b.replace(x0=jnp.asarray(np.asarray(params_b.x0)[:, sl]))
            Z_i = jax.tree_util.tree_map(
                lambda l: jnp.asarray(np.asarray(l)[..., sl] if l.ndim > 1 else l),
                Zb,
            )
            r = ref(p_i, Z_i)
            st_ref.append(np.asarray(r["status"]))
            U_ref.append(np.asarray(r["Z"].U))
            viol_ref.append(np.asarray(r["stats"].violations))
    st_ref = np.concatenate(st_ref)
    U_ref = np.concatenate(U_ref, axis=-1)
    viol_ref = np.concatenate(viol_ref)
    solved = int(SolverStatus.SOLVED)
    stalled = int(SolverStatus.SOLVED_STALLED)
    same_status = int((status == st_ref).sum())
    dU = float(np.abs(U - U_ref).max())
    folds = dict(
        viol_max=(float(viol_max), float(viol_ref.max())),
        n_solved=(int(n_solved), int((st_ref == solved).sum())),
        n_stalled=(int(n_stalled), int((st_ref == stalled).sum())),
    )
    print(
        f"[four] {batch} lanes on 4 cards: statuses equal {same_status}/{batch}, "
        f"max |dU| {dU:.3e}, folds (sharded, unsharded) {folds}"
    )
    if same_status != batch:
        raise AssertionError(f"statuses differ on {batch - same_status} lanes")
    # f32: XLA may fuse the sharded program differently from the unsharded
    # one, moving lanes in the last bits; lanes that both solve still land
    # in the same stopping ball
    if not dU <= 1e-3:
        raise AssertionError(f"max |dU| {dU} between sharded and unsharded")
    if folds["n_solved"][0] != folds["n_solved"][1] or (
        folds["n_stalled"][0] != folds["n_stalled"][1]
    ):
        raise AssertionError(f"fleet counts differ: {folds}")
    if not abs(folds["viol_max"][0] - folds["viol_max"][1]) <= 1e-6 + 1e-3 * abs(
        folds["viol_max"][1]
    ):
        raise AssertionError(f"pmax of violations differs: {folds}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--four", action="store_true",
        help="run only the sharded fleet solve on four GPUs",
    )
    args = ap.parse_args()

    import jax

    if jax.default_backend() != "gpu":
        print(
            f"chip_smoke: no GPU (JAX backend {jax.default_backend()!r})",
            file=sys.stderr,
        )
        return 2
    from altro_jax.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    card = card_line()
    phase_device(card)
    if args.four:
        phase_four()
    else:
        phase_kernels()
        phase_main(card.splitlines()[0])
        phase_tests()
    print(card)
    dev = jax.devices()[0]
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(jax.devices()),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
