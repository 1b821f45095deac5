"""Problem definition and compilation to a stacked, vmappable form.

`Problem` mirrors the reference's per-knot container
(`altro/problem/problem.hpp:65-307`): per-knot cost/dynamics/constraint
entries plus an initial state.  `Problem.compile()` then does what has no
analog in the reference — it groups knot points into *families* that share
the same function structure (stage cost vs terminal cost, bound vs goal vs
obstacle constraints) and stacks their parameters, so each family evaluates
as ONE batched XLA kernel vmapped over its knot indices instead of N virtual
calls through object pointers.  This is the batched replacement for the
reference's thread-pool chunking over knot points
(`altro/ilqr/ilqr.hpp:350-366`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Optional, Sequence, Union

import jax.numpy as jnp
import numpy as np

from .._pytree import pytree_dataclass, static_field
from .constraints import Cone, Constraint
from .costs import Cost
from .dynamics import DiscreteModel

KnotSel = Union[int, Iterable[int]]


def _as_knots(k: KnotSel) -> list[int]:
    if isinstance(k, (int, np.integer)):
        return [int(k)]
    return [int(i) for i in k]


@dataclasses.dataclass
class _CostFamily:
    fn: Any
    expand_fn: Any
    name: str
    knots: np.ndarray  # sorted knot indices
    shared: bool  # params shared across knots vs stacked along axis 0
    cost: Any = None  # representative Cost (for kernel special-casing)


@dataclasses.dataclass
class _ConstraintFamily:
    fn: Any
    jac_fn: Any
    cone: Cone
    dim: int
    label: str
    knots: np.ndarray
    shared: bool
    constraint: Any = None  # representative Constraint


@dataclasses.dataclass
class _DynamicsFamily:
    fn: Any
    jac_fn: Any
    name: str
    knots: np.ndarray
    shared: bool
    model: Any = None  # representative DiscreteModel (for integrator metadata)


@pytree_dataclass
class ProblemParams:
    """All dynamic (traced/batchable) data of a compiled problem.

    The solver is a pure function of this pytree: re-solving with a new
    initial state, reference, or obstacle layout costs no recompilation, and
    `vmap` over this pytree gives batched multi-scenario solves.
    """

    x0: Any
    dynamics: tuple
    costs: tuple
    constraints: tuple


class Problem:
    """Trajectory optimization problem over N segments (N+1 knot points).

    Cost / dynamics / constraint setters mirror `problem.hpp:121-202`;
    `k` may be an int or an iterable of knot indices.
    """

    def __init__(self, N: int):
        if N <= 0:
            raise ValueError("Number of segments must be positive")
        self.N = N
        self._costs: list[Optional[Cost]] = [None] * (N + 1)
        self._dynamics: list[Optional[DiscreteModel]] = [None] * N
        self._constraints: list[list[Constraint]] = [[] for _ in range(N + 1)]
        self._x0 = None

    # ------------------------------------------------------------------ setters
    def set_initial_state(self, x0) -> None:
        self._x0 = jnp.asarray(x0)

    def set_cost(self, cost: Cost, k: KnotSel) -> None:
        for i in _as_knots(k):
            self._check_index(i, self.N)
            self._costs[i] = cost

    def set_dynamics(self, model: DiscreteModel, k: KnotSel) -> None:
        for i in _as_knots(k):
            self._check_index(i, self.N - 1)
            self._dynamics[i] = model

    def set_constraint(self, con: Constraint, k: KnotSel) -> None:
        for i in _as_knots(k):
            self._check_index(i, self.N)
            self._constraints[i].append(con)

    def _check_index(self, k: int, kmax: int) -> None:
        if not 0 <= k <= kmax:
            raise IndexError(f"Knot index {k} out of range [0, {kmax}]")

    # ------------------------------------------------------------------ queries
    @property
    def n(self) -> int:
        model = next(m for m in self._dynamics if m is not None)
        return model.n

    @property
    def m(self) -> int:
        model = next(m for m in self._dynamics if m is not None)
        return model.m

    def num_constraints(self, k: Optional[int] = None) -> int:
        """Constraint rows at knot k, or total (`problem.hpp:213-236`)."""
        if k is None:
            return sum(self.num_constraints(i) for i in range(self.N + 1))
        return sum(c.dim for c in self._constraints[k])

    def is_fully_defined(self) -> bool:
        """All knots have costs, all segments dynamics, x0 set
        (`problem.cpp:12-40`)."""
        return (
            self._x0 is not None
            and all(c is not None for c in self._costs)
            and all(d is not None for d in self._dynamics)
        )

    # ------------------------------------------------------------------ compile
    def compile(self) -> "CompiledProblem":
        if not self.is_fully_defined():
            raise ValueError("Problem is not fully defined")
        n, m = self.n, self.m
        for k, model in enumerate(self._dynamics):
            if model.n != n or model.m != m:
                raise ValueError(f"Inconsistent model dimensions at knot {k}")

        cost_fams, cost_params = _group(
            list(enumerate(self._costs)),
            key=lambda c: (c.fn, c.expand_fn),
            make=lambda c, knots, shared: _CostFamily(
                c.fn, c.expand_fn, c.name, knots, shared, cost=c
            ),
        )
        dyn_fams, dyn_params = _group(
            list(enumerate(self._dynamics)),
            key=lambda d: (d.fn, d.jac_fn),
            make=lambda d, knots, shared: _DynamicsFamily(
                d.fn, d.jac_fn, d.name, knots, shared, model=d
            ),
        )
        con_entries = [
            (k, c) for k, cons in enumerate(self._constraints) for c in cons
        ]
        con_fams, con_params = _group(
            con_entries,
            key=lambda c: (c.fn, c.jac_fn, c.cone, c.dim),
            make=lambda c, knots, shared: _ConstraintFamily(
                c.fn, c.jac_fn, c.cone, c.dim, c.label, knots, shared,
                constraint=c,
            ),
        )
        params = ProblemParams(
            x0=self._x0,
            dynamics=tuple(dyn_params),
            costs=tuple(cost_params),
            constraints=tuple(con_params),
        )
        return CompiledProblem(
            N=self.N,
            n=n,
            m=m,
            cost_families=tuple(cost_fams),
            dynamics_families=tuple(dyn_fams),
            constraint_families=tuple(con_fams),
            params=params,
        )


def _group(entries, key, make):
    """Group (knot, obj) entries by function identity into families.

    Params become shared when every knot holds the *same* param pytree
    (by object identity of the first leaf-bearing object), else stacked along
    a leading knot axis.
    """
    import jax

    families = []
    fam_params = []
    buckets: dict[Any, list[tuple[int, Any]]] = {}
    order: list[Any] = []
    for k, obj in entries:
        kk = key(obj)
        if kk not in buckets:
            buckets[kk] = []
            order.append(kk)
        buckets[kk].append((k, obj))
    for kk in order:
        items = sorted(buckets[kk], key=lambda t: t[0])
        knots = np.asarray([k for k, _ in items], np.int32)
        objs = [o for _, o in items]
        first = objs[0]
        shared = all(o.params is first.params for o in objs) or all(
            o is first for o in objs
        )
        if shared:
            params = first.params
        else:
            params = jax.tree_util.tree_map(
                lambda *leaves: jnp.stack(leaves), *[o.params for o in objs]
            )
        families.append(make(first, knots, shared))
        fam_params.append(params)
    return families, fam_params


class CompiledProblem:
    """Static structure of a compiled problem.

    Holds the function families (static: Python callables and knot index
    arrays) and the initial `ProblemParams` pytree (dynamic).  Solver
    factories close over the static part; the dynamic part is an argument of
    the jitted solve.
    """

    def __init__(
        self,
        N: int,
        n: int,
        m: int,
        cost_families,
        dynamics_families,
        constraint_families,
        params: ProblemParams,
    ):
        self.N = N
        self.n = n
        self.m = m
        self.cost_families = cost_families
        self.dynamics_families = dynamics_families
        self.constraint_families = constraint_families
        self.params = params
        # Precomputed per-segment dispatch for the rollout scans.
        fam_id = np.zeros(N, np.int32)
        idx_in_fam = np.zeros(N, np.int32)
        for fi, fam in enumerate(dynamics_families):
            fam_id[fam.knots] = fi
            idx_in_fam[fam.knots] = np.arange(len(fam.knots), dtype=np.int32)
        self.dyn_fam_id = fam_id
        self.dyn_idx_in_fam = idx_in_fam

    @property
    def num_constraint_rows(self) -> int:
        return sum(f.dim * len(f.knots) for f in self.constraint_families)

    def dynamics_step(self, dyn_params: tuple, k, x, u, t, h):
        """Evaluate x_{k+1} = f_k(x, u, t, h) with per-knot family dispatch.

        Single-family problems (every shipped example) compile to a direct
        call; heterogeneous problems use `lax.switch`.
        """
        import jax

        fams = self.dynamics_families
        if len(fams) == 1:
            return self._fam_step(fams[0], dyn_params[0], k, x, u, t, h)
        branches = [
            (lambda p, fam=fam, fp=fp: self._fam_step(fam, fp, p[0], x, u, t, h))
            for fam, fp in zip(fams, dyn_params)
        ]
        fam_id = jnp.asarray(self.dyn_fam_id)[k]
        idx = jnp.asarray(self.dyn_idx_in_fam)[k]
        return jax.lax.switch(fam_id, branches, (idx,))

    def _fam_step(self, fam, fp, k, x, u, t, h):
        import jax

        if fam.shared:
            return fam.fn(fp, x, u, t, h)
        # params stacked over the family's knots; k is the within-family index
        pk = jax.tree_util.tree_map(lambda leaf: leaf[k], fp)
        return fam.fn(pk, x, u, t, h)
