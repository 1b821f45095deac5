#!/usr/bin/env python
"""Device-side MPC tick latency vs the 100 Hz budget (BASELINE config 4).

Per-tick HOST dispatch adds a host round trip to every tick, so this
measures the DEVICE tick latency directly: `rollout_ticks` chains K
warm-started re-solve + plant steps into ONE jitted `lax.scan` (one
dispatch for the whole chain), so wall/K is the amortized on-device tick
time — the number that matters for a controller deployed without a host
round-trip in the loop.  The host-dispatched single-tick latency is
recorded alongside; the difference is the dispatch round trip.

The control knob is the PER-TICK iteration cap: the warm-started fleet's p50
is 2 iterations, and real-time iteration practice (RTI) runs 1-3 iLQR
iterations per tick, letting the warm start carry convergence across
ticks.  A 10-iteration cap spends every tick waiting for the lockstep
fleet's stragglers; cap 3 is the
deadline-meeting configuration.  Closed-loop quality is checked over the
FULL maneuver (ticks x h covers the 3 s turn): p99 fleet goal distance at
the end.

Run on the GPU host: python perf/mpc_device_latency.py
"""
import json
import os
import sys
import time

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import jax
import jax.numpy as jnp

from altro_jax import BatchedMPC, MPC, SolverOptions, SolverStatus
from altro_jax.models.problems import UnicycleProblem
from altro_jax.models.unicycle import unicycle_rk4
from altro_jax.solver.batched import to_batch_last

TICKS = 100  # x h=0.03 s -> covers the full 3 s maneuver


def _time_chain(run, out_probe=1, reps=3):
    out = run()
    jax.block_until_ready(out[out_probe])
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = run()
        jax.block_until_ready(out[out_probe])
        walls.append(time.perf_counter() - t0)
    return out, float(np.median(walls))


def single(defn, prob, cap):
    mpc = MPC(prob, SolverOptions(
        max_iterations_total=cap, max_iterations_inner=cap, scan_unroll=4,
    ), shift=True)
    h = defn.h
    plant = lambda x, u: unicycle_rk4()(x, u, 0.0, h)
    state = mpc.init(defn.initial_trajectory())
    x = jnp.zeros(3, jnp.float32)
    # host-dispatched single tick, for the round-trip comparison
    u0, st_w = mpc.step(state, x)
    jax.block_until_ready(u0)
    host_lat = []
    for _ in range(10):
        t0 = time.perf_counter()
        u0, st_w = mpc.step(st_w, x)
        jax.block_until_ready(u0)
        host_lat.append((time.perf_counter() - t0) * 1e3)
    # device-chained ticks from the same warm state
    (st, xf, X, U), wall = _time_chain(
        lambda: mpc.rollout_ticks(st_w, x, plant, TICKS)
    )
    ms = wall * 1e3 / TICKS
    dist = float(np.linalg.norm(np.asarray(X[-1])[:2] - np.asarray(defn.xf)[:2]))
    return {
        "mode": "single_controller",
        "iters_per_tick_cap": cap,
        "device_ms_per_tick": round(ms, 3),
        "meets_100hz_budget": bool(ms <= 10.0),
        "host_dispatched_ms_median": round(float(np.median(host_lat)), 3),
        "dispatch_rtt_ms_implied": round(float(np.median(host_lat)) - ms, 3),
        "final_goal_xy_dist_m": round(dist, 5),
        "ticks_chained": TICKS,
    }


def fleet(defn, prob, B, cap):
    mpc = BatchedMPC(prob, SolverOptions(
        backward_pass="fused", forward_pass="pallas", scan_unroll=4,
        max_iterations_total=cap, max_iterations_inner=cap,
    ), shift=True)
    h = defn.h
    step1 = unicycle_rk4()
    plant = jax.vmap(
        lambda x, u: step1(x, u, 0.0, h), in_axes=-1, out_axes=-1
    )
    Z0 = defn.initial_trajectory()
    Zb = to_batch_last(jax.tree_util.tree_map(
        lambda l: jnp.broadcast_to(l, (B,) + l.shape), Z0
    ))
    state = mpc.init(Zb)
    rng = np.random.default_rng(0)
    xB = jnp.asarray(rng.uniform(-0.1, 0.1, size=(3, B)), jnp.float32)
    # warm up: 2 host ticks so the chain measures steady-state re-solves
    u0, state = mpc.step(state, xB)
    u0, state = mpc.step(state, xB)
    jax.block_until_ready(u0)
    (st, xf, X, U), wall = _time_chain(
        lambda: mpc.rollout_ticks(state, xB, plant, TICKS)
    )
    ms = wall * 1e3 / TICKS
    solved = int(
        (np.asarray(st.status) == int(SolverStatus.SOLVED)).sum()
    )
    goal_dist = np.linalg.norm(
        np.asarray(X[-1])[:2] - np.asarray(defn.xf, np.float32)[:2, None],
        axis=0,
    )
    return {
        "mode": f"fleet_{B}_controllers_device_chained",
        "iters_per_tick_cap": cap,
        "device_ms_per_tick": round(ms, 3),
        "meets_100hz_budget": bool(ms <= 10.0),
        "controller_steps_per_s": round(B * 1e3 / ms, 1),
        "fleet_solved_last_tick": solved,
        "goal_xy_dist_p99_m": round(float(np.percentile(goal_dist, 99)), 5),
        "goal_xy_dist_p50_m": round(float(np.percentile(goal_dist, 50)), 5),
        "ticks_chained": TICKS,
    }


def main() -> None:
    from altro_jax.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    defn = UnicycleProblem(dtype=jnp.float32)
    prob = defn.make_problem(add_constraints=True).compile()
    print(json.dumps(single(defn, prob, cap=3)), flush=True)
    best = None
    for B, cap in ((1024, 10), (1024, 3), (1024, 2), (2048, 3), (4096, 3)):
        row = fleet(defn, prob, B, cap)
        print(json.dumps(row), flush=True)
        if row["meets_100hz_budget"] and (best is None or B > best):
            best = B
    print(json.dumps({
        "summary": "largest fleet width meeting the 100 Hz budget on-device",
        "max_width_within_10ms": best,
        "device": str(jax.devices()[0]),
    }), flush=True)


if __name__ == "__main__":
    main()
