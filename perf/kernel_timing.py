#!/usr/bin/env python
"""Time the Triton kernels against the XLA programs they replace, on a GPU.

    python perf/kernel_timing.py [--batch 4096] [--blocks 32,64,128]
                                 [--reps 5] [--no-e2e] [--pairs fused/pallas,...]
                                 [--out FILE.jsonl]

Parking fleet (unicycle turn-90, N=100, f32, B=4096 unless `--batch`; a
width that is not a multiple of the lanes per program is padded):
  * kernel level, per lanes-per-program block size: one fused backward call
    vs `expand` + `riccati_scan` + `total_cost`, and one forward call vs
    `closed_loop_rollout` + `total_cost` (median of 20 calls after warm-up);
  * end to end: `bench.make_solver` with each (backward_pass, forward_pass)
    pair — both kernels, each kernel alone, all-scan — median of `--reps`
    solves after warm-up, all in this one process.

Prints one JSON line per measurement, with the card's name and power limit,
and appends them to `--out` when given.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

PAIRS = "fused/pallas,fused/scan,scan/pallas,scan/scan"


def _median_ms(fn, *args, reps=20):
    import jax

    jax.block_until_ready(fn(*args))
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        walls.append(time.perf_counter() - t0)
    return float(np.median(walls) * 1e3)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--blocks", default="32,64,128")
    ap.add_argument("--pairs", default=PAIRS,
                    help="backward/forward pass pairs timed end to end")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--no-e2e", action="store_true")
    ap.add_argument("--out", help="also append the JSON lines to this file")
    args = ap.parse_args()
    batch = args.batch

    import jax
    import jax.numpy as jnp

    if jax.default_backend() != "gpu":
        print("kernel_timing: needs a GPU", file=sys.stderr)
        return 2
    from altro_jax.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    import bench
    from altro_jax.models.problems import UnicycleProblem
    from altro_jax.ops.backward_fused_pallas import BackwardFusedKernel
    from altro_jax.ops.forward_pallas import ForwardKernel
    from altro_jax.solver.batched import ALSolverBatched

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    def emit(rec):
        line = json.dumps(dict(rec, card=card, batch=batch))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as log:
                log.write(line + "\n")

    defn = UnicycleProblem(dtype=jnp.float32)
    prob = defn.make_problem(add_constraints=True).compile()
    opts = bench.bench_options()
    ref = ALSolverBatched(prob, opts.replace(backward_pass="scan", forward_pass="scan"))
    params, Zb = bench.make_batch(prob, defn, batch, jnp.float32)
    Zb = jax.jit(ref.rollout)(params, Zb)
    al = ref.al_state_init(batch, jnp.float32)
    rho = jnp.zeros((batch,), jnp.float32)

    def xla_bwd(p, a, Z, r):
        return ref.riccati_scan(ref.expand(p, a, Z), r), ref.total_cost(p, a, Z)

    (K, d, *_), _ = jax.jit(xla_bwd)(params, al, Zb, rho)
    alpha = jnp.ones((batch,), jnp.float32)

    def xla_fwd(p, a, Z, K, d, al_):
        Zbar, valid, status = ref.closed_loop_rollout(p, Z, K, d, al_)
        return Zbar, valid, status, ref.total_cost(p, a, Zbar)

    emit(dict(what="xla_backward_ms", ms=_median_ms(
        jax.jit(xla_bwd), params, al, Zb, rho)))
    emit(dict(what="xla_forward_ms", ms=_median_ms(
        jax.jit(xla_fwd), params, al, Zb, K, d, alpha)))
    for block in (int(b) for b in args.blocks.split(",")):
        bwd = BackwardFusedKernel(prob, opts, block=block)
        fwd = ForwardKernel(prob, opts, block=block)
        t0 = time.perf_counter()
        kb = jax.jit(lambda p, a, Z, r: bwd(p, bwd.pad_al(a), Z, r))
        kf = jax.jit(
            lambda p, a, Z, K, d, al_: fwd(p, fwd.pad_al(a), Z, K, d, al_)
        )
        jax.block_until_ready(kb(params, al, Zb, rho))
        jax.block_until_ready(kf(params, al, Zb, K, d, alpha))
        emit(dict(what="kernel_compile_s", block=block,
                  s=time.perf_counter() - t0))
        emit(dict(what="kernel_backward_ms", block=block,
                  ms=_median_ms(kb, params, al, Zb, rho)))
        emit(dict(what="kernel_forward_ms", block=block,
                  ms=_median_ms(kf, params, al, Zb, K, d, alpha)))

    if args.no_e2e:
        return 0
    params, Zb = bench.make_batch(prob, defn, batch, jnp.float32)
    for bp, fp in (pair.split("/") for pair in args.pairs.split(",")):
        solver = bench.make_solver(prob, batch, backward_pass=bp, forward_pass=fp)
        t0 = time.perf_counter()
        res = solver.solve(params, Zb)
        jax.block_until_ready(res["Z"].U)
        first = time.perf_counter() - t0
        walls = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            res = solver.solve(params, Zb)
            jax.block_until_ready(res["Z"].U)
            walls.append(time.perf_counter() - t0)
        hist = bench.status_histogram(np.asarray(res["status"]))
        emit(dict(
            what="e2e", backward_pass=bp, forward_pass=fp,
            blocks=dict(forward=ForwardKernel.gpu_block,
                        backward=BackwardFusedKernel.gpu_block),
            solves_per_s=batch / float(np.median(walls)),
            wall_ms=[w * 1e3 for w in walls], first_solve_s=first,
            status_hist=hist,
        ))
    return 0


if __name__ == "__main__":
    sys.exit(main())
