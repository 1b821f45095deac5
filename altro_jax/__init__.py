"""altro_jax — batched AL-iLQR trajectory optimization in JAX.

A from-scratch JAX/XLA implementation of the capability set of altro-cpp
(AL-iLQR / ALTRO): nonlinear trajectory optimization with equality,
inequality, and conic constraints, built to solve thousands of problems at
once on a GPU — pure functions over pytrees, batch-last fleet solves with
Pallas (Triton) kernels for the hot sweeps, `lax.scan` / associative-scan
Riccati recursions, and `jax.sharding` meshes for multi-device scaling.
"""

from .options import LogLevel, SolverOptions
from .types import SolverStats, SolverStatus, Trajectory, initial_trajectory
from .problem.costs import Cost, lqr_cost, quadratic_cost
from .problem.constraints import (
    Cone,
    Constraint,
    EQUALITY,
    INEQUALITY,
    circle_constraint,
    control_bound,
    goal_constraint,
)
from .problem.dynamics import (
    ContinuousModel,
    DiscreteModel,
    discretize,
    euler_step,
    rk4_step,
)
from .problem.problem import CompiledProblem, Problem, ProblemParams
from .solver.ilqr import ILQRSolver
from .solver.al import ALSolver
from .solver.mpc import MPC, BatchedMPC

__version__ = "0.1.0"

__all__ = [
    "ALSolver",
    "BatchedMPC",
    "CompiledProblem",
    "Cone",
    "Constraint",
    "ContinuousModel",
    "Cost",
    "DiscreteModel",
    "EQUALITY",
    "ILQRSolver",
    "INEQUALITY",
    "LogLevel",
    "MPC",
    "Problem",
    "ProblemParams",
    "SolverOptions",
    "SolverStats",
    "SolverStatus",
    "Trajectory",
    "circle_constraint",
    "control_bound",
    "discretize",
    "euler_step",
    "goal_constraint",
    "initial_trajectory",
    "lqr_cost",
    "quadratic_cost",
    "rk4_step",
]
