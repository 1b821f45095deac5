"""Canned benchmark problems mirroring `examples/problems/`.

`UnicycleProblem` scenarios kTurn90 / kThreeObstacles
(`examples/problems/unicycle.cpp:11-89`) and `TripleIntegratorProblem`
(`examples/problems/triple_integrator.hpp:22-105`), with the same horizon,
weights, bounds, and initial guesses so the Altro.jl-derived golden values in
the reference test suite apply directly.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from ..problem.constraints import circle_constraint, control_bound, goal_constraint
from ..problem.costs import lqr_cost
from ..problem.problem import Problem
from ..types import Trajectory, initial_trajectory
from .triple_integrator import triple_integrator_rk4
from .unicycle import unicycle_rk4

TURN90 = "turn90"
THREE_OBSTACLES = "three_obstacles"


@dataclasses.dataclass
class UnicycleProblem:
    """Unicycle parking / obstacle-avoidance benchmark
    (`examples/problems/unicycle.hpp:26-122`)."""

    scenario: str = TURN90
    N: int = 100
    dtype: object = jnp.float64

    def __post_init__(self):
        self.n = 3
        self.m = 2
        self.v_bnd = 1.5
        self.w_bnd = 1.5
        if self.scenario == TURN90:
            self.tf = 3.0
            # The reference computes h = tf/N in float32
            # (`unicycle.hpp:79`, float tf); keep the same value.
            h = float(np.float32(self.tf) / np.float32(self.N))
            self.h = h
            self.Q = np.eye(3) * (1e-2 * h)
            self.R = np.eye(2) * (1e-2 * h)
            self.Qf = np.eye(3) * 100.0
            self.x0 = np.zeros(3)
            self.xf = np.array([1.5, 1.5, np.pi / 2])
            self.u0 = np.full(2, 0.1)
            self.lb = np.array([-self.v_bnd, -self.w_bnd])
            self.ub = np.array([+self.v_bnd, +self.w_bnd])
            self.obstacles = None
        elif self.scenario == THREE_OBSTACLES:
            self.tf = 5.0
            h = float(np.float32(self.tf) / np.float32(self.N))
            self.h = h
            self.Q = np.eye(3) * (1.0 * h)
            self.R = np.eye(2) * (0.5 * h)
            self.Qf = np.eye(3) * 10.0
            self.x0 = np.zeros(3)
            self.xf = np.array([3.0, 3.0, 0.0])
            self.u0 = np.full(2, 0.01)
            self.lb = np.array([0.0, -3.0])
            self.ub = np.array([3.0, +3.0])
            scaling = 3.0
            self.obstacles = (
                np.array([0.25, 0.5, 0.75]) * scaling,  # cx
                np.array([0.25, 0.5, 0.75]) * scaling,  # cy
                np.full(3, 0.425),  # radii
            )
        else:
            raise ValueError(f"Unknown scenario {self.scenario!r}")
        self.uref = np.zeros(2)

    def make_problem(self, add_constraints: bool = True) -> Problem:
        dt = jnp.result_type(self.dtype)
        N = self.N
        prob = Problem(N)
        stage = lqr_cost(
            jnp.asarray(self.Q, dt), jnp.asarray(self.R, dt),
            jnp.asarray(self.xf, dt), jnp.asarray(self.uref, dt),
        )
        term = lqr_cost(
            jnp.asarray(self.Qf, dt), jnp.zeros((2, 2), dt),
            jnp.asarray(self.xf, dt), jnp.asarray(self.uref, dt), terminal=True,
        )
        prob.set_cost(stage, range(N))
        prob.set_cost(term, N)
        prob.set_dynamics(unicycle_rk4(), range(N))
        if self.obstacles is not None:
            cx, cy, cr = self.obstacles
            obs = circle_constraint(
                jnp.asarray(cx, dt), jnp.asarray(cy, dt), jnp.asarray(cr, dt)
            )
            prob.set_constraint(obs, range(1, N))  # `unicycle.cpp:54-58`
        if add_constraints:
            prob.set_constraint(
                control_bound(jnp.asarray(self.lb, dt), jnp.asarray(self.ub, dt)),
                range(N),
            )
            prob.set_constraint(goal_constraint(jnp.asarray(self.xf, dt)), N)
        prob.set_initial_state(jnp.asarray(self.x0, dt))
        return prob

    def initial_trajectory(self) -> Trajectory:
        return initial_trajectory(
            self.n, self.m, self.N, self.h, u0=self.u0, dtype=self.dtype
        )


@dataclasses.dataclass
class TripleIntegratorProblem:
    """Triple-integrator benchmark (`examples/problems/triple_integrator.hpp:22-105`)."""

    dof: int = 2
    N: int = 10
    h: float = 0.1
    dtype: object = jnp.float64

    def __post_init__(self):
        dof = self.dof
        self.n = 3 * dof
        self.m = dof
        self.Q = np.eye(self.n) * 1.0
        self.R = np.eye(self.m) * 0.001
        self.Qf = np.eye(self.n) * 1e5
        self.xf = np.zeros(self.n)
        self.x0 = np.zeros(self.n)
        self.ubnd = np.zeros(dof)
        for i in range(dof):
            self.xf[i] = i + 1
            self.x0[i] = -(i + 1)
            self.ubnd[i] = 100 * (i + 1)

    def make_problem(self, add_constraints: bool = False) -> Problem:
        dt = jnp.result_type(self.dtype)
        N = self.N
        prob = Problem(N)
        stage = lqr_cost(
            jnp.asarray(self.Q, dt), jnp.asarray(self.R, dt),
            jnp.asarray(self.xf, dt), jnp.zeros(self.m, dt),
        )
        term = lqr_cost(
            jnp.asarray(self.Qf, dt), jnp.zeros((self.m, self.m), dt),
            jnp.asarray(self.xf, dt), jnp.zeros(self.m, dt), terminal=True,
        )
        prob.set_cost(stage, range(N))
        prob.set_cost(term, N)
        prob.set_dynamics(triple_integrator_rk4(self.dof), range(N))
        if add_constraints:
            prob.set_constraint(
                control_bound(
                    jnp.asarray(-self.ubnd, dt), jnp.asarray(self.ubnd, dt)
                ),
                range(N),
            )
            prob.set_constraint(goal_constraint(jnp.asarray(self.xf, dt)), N)
        prob.set_initial_state(jnp.asarray(self.x0, dt))
        return prob

    def initial_trajectory(self) -> Trajectory:
        return initial_trajectory(self.n, self.m, self.N, self.h, dtype=self.dtype)


@dataclasses.dataclass
class QuadrotorProblem:
    """Quadrotor hover-to-hover transfer (n=13, m=4; `models/quadrotor.py`):
    the model-zoo problem that exercises the kernels beyond the unicycle's
    n=3, with rotor-thrust bounds on every stage."""

    N: int = 50
    tf: float = 2.5
    dtype: object = jnp.float32

    def __post_init__(self):
        from .quadrotor import hover_controls, hover_state

        self.n, self.m = 13, 4
        self.h = self.tf / self.N
        self.x0 = np.asarray(hover_state((0.0, 0.0, 1.0)))
        self.xf = np.asarray(hover_state((1.5, 1.0, 2.0)))
        self.uhover = np.asarray(hover_controls())

    def make_problem(self, add_constraints: bool = True) -> Problem:
        from .quadrotor import quadrotor_rk4

        dt = jnp.result_type(self.dtype)
        n, m, N, h = self.n, self.m, self.N, self.h
        xf = jnp.asarray(self.xf, dt)
        uh = jnp.asarray(self.uhover, dt)
        prob = Problem(N)
        prob.set_initial_state(jnp.asarray(self.x0, dt))
        prob.set_dynamics(quadrotor_rk4(), range(N))
        prob.set_cost(
            lqr_cost(jnp.eye(n, dtype=dt) * 1e-2 * h,
                     jnp.eye(m, dtype=dt) * 1e-1 * h, xf, uh),
            range(N),
        )
        prob.set_cost(
            lqr_cost(jnp.eye(n, dtype=dt) * 100.0, jnp.zeros((m, m), dt),
                     xf, uh, terminal=True),
            N,
        )
        if add_constraints:
            prob.set_constraint(
                control_bound(jnp.zeros(m, dt), jnp.full(m, 4.0, dt)),
                range(N),
            )
        return prob

    def initial_trajectory(self) -> Trajectory:
        return initial_trajectory(
            self.n, self.m, self.N, self.h, u0=self.uhover, dtype=self.dtype
        )
