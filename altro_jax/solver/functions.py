"""Batched problem functions: costs, expansions, constraints, rollouts.

This module is the batched replacement for the reference's per-knot object
graph.  Where altro-cpp walks N+1 `KnotPointFunctions` objects on a thread
pool (`altro/ilqr/ilqr.hpp:350-366`, `knot_point_function_type.hpp:107-128`),
here every family of knot points evaluates as one `vmap`-batched XLA kernel
and scatters its results into stacked `[N+1, ...]` tensors.  The augmented-
Lagrangian penalty terms (`augmented_lagrangian/al_cost.hpp:264-308`,
`constraints/constraint_values.hpp:111-177`) are fused into the same cost
expansion arrays.
"""
from __future__ import annotations

from typing import Any, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .._pytree import pytree_dataclass, static_field
from ..options import SolverOptions
from ..problem.constraints import (
    Cone,
    cone_jacobian_diag,
    cone_project,
    cone_project_rows,
    cone_violation,
    dual_cone,
)
from ..problem.costs import CostExpansionTerms
from ..problem.problem import CompiledProblem, ProblemParams
from ..types import Trajectory


@pytree_dataclass
class ConState:
    """Dual/penalty state for one constraint family.

    lam: [nk, p] Lagrange multipliers.  rho: [nk] scalar penalty per knot
    (the reference stores a per-element penalty vector but always sets and
    scales it uniformly and reads element 0, `constraint_values.hpp:44,79,112`).
    """

    lam: jax.Array
    rho: jax.Array


ALState = tuple  # tuple[ConState, ...] in constraint-family order


@pytree_dataclass
class Expansions:
    """Stacked cost/dynamics expansions for all knot points.

    The struct-of-arrays analog of the per-knot `CostExpansion`,
    `DynamicsExpansion` storage (`ilqr/cost_expansion.hpp:26`,
    `ilqr/dynamics_expansion.hpp:17`).
    """

    costs: jax.Array  # [N+1]
    lx: jax.Array  # [N+1, n]
    lu: jax.Array  # [N+1, m]
    lxx: jax.Array  # [N+1, n, n]
    lxu: jax.Array  # [N+1, n, m]
    luu: jax.Array  # [N+1, m, m]
    A: jax.Array  # [N, n, n]
    B: jax.Array  # [N, n, m]


def _al_value(cone: Cone, c: jax.Array, state: ConState) -> jax.Array:
    """Rowwise AL penalty value (||Π_{K*}(λ−ρc)||² − ||λ||²)/(2ρ)
    (`constraint_values.hpp:111-119`)."""
    dual = dual_cone(cone)
    s = state.lam - state.rho[:, None] * c
    lam_proj = cone_project_rows(dual, s)
    return (
        jnp.sum(lam_proj * lam_proj, axis=-1) - jnp.sum(state.lam * state.lam, axis=-1)
    ) / (2.0 * state.rho)


def _vmap_family(fam, fam_params, fn, X, U, extra=()):
    """Apply `fn(params, x, u, *extra)` vmapped over a family's knots."""
    knots = fam.knots
    xk = X[knots]
    uk = U[knots]
    if fam.shared:
        return jax.vmap(lambda x, u: fn(fam_params, x, u, *extra))(xk, uk)
    return jax.vmap(lambda p, x, u: fn(p, x, u, *extra))(fam_params, xk, uk)



def _knot_row(fam, knot: int) -> int:
    """Row of knot `knot` within a family's stacked [nk, ...] arrays."""
    rows = np.flatnonzero(np.asarray(fam.knots) == int(knot))
    if rows.size == 0:
        raise IndexError(
            f"constraint {fam.label!r} has no knot {int(knot)} "
            f"(knots {np.asarray(fam.knots).tolist()[:5]}...)"
        )
    return int(rows[0])

class ProblemFunctions:
    """Pure batched functions for one compiled problem + options.

    Every method is traceable (jit/vmap-safe) and functional: AL state and
    trajectories go in and come out as explicit pytrees.
    """

    def __init__(self, prob: CompiledProblem, opts: SolverOptions):
        self.prob = prob
        self.opts = opts

    # ---------------------------------------------------------------- al state
    def al_state_init(self, dtype=None) -> ALState:
        """Zero duals, initial penalties (`al_solver.hpp:288-302`)."""
        dtype = jnp.result_type(dtype or jnp.zeros(0).dtype)
        out = []
        for fam in self.prob.constraint_families:
            nk = len(fam.knots)
            out.append(
                ConState(
                    lam=jnp.zeros((nk, fam.dim), dtype),
                    rho=jnp.full((nk,), self.opts.initial_penalty, dtype),
                )
            )
        return tuple(out)

    def _family_index(self, family) -> int:
        """Resolve a constraint family by index or label."""
        fams = self.prob.constraint_families
        if isinstance(family, str):
            matches = [i for i, f in enumerate(fams) if f.label == family]
            if not matches:
                raise KeyError(
                    f"no constraint family labeled {family!r}; have "
                    f"{[f.label for f in fams]}"
                )
            if len(matches) > 1:
                raise KeyError(f"label {family!r} is ambiguous: {matches}")
            return matches[0]
        i = int(family)
        if not 0 <= i < len(fams):
            raise IndexError(
                f"constraint family index {i} out of range [0, {len(fams)})"
            )
        return i

    def set_penalty(
        self, al: ALState, rho: float, family=None, knot=None
    ) -> ALState:
        """Set penalties (`al_solver.hpp:272-277`; per-constraint get/set
        `al_cost.hpp:171-231`).

        `family=None` sets every constraint (the reference's
        `SetPenalty(rho)`); a family index or label restricts to one
        constraint family, and `knot` further restricts to a single knot
        point of that family.
        """
        if family is None:
            if knot is not None:
                raise ValueError("knot requires a family")
            return tuple(s.replace(rho=jnp.full_like(s.rho, rho)) for s in al)
        i = self._family_index(family)
        s = al[i]
        if knot is None:
            s = s.replace(rho=jnp.full_like(s.rho, rho))
        else:
            row = _knot_row(self.prob.constraint_families[i], knot)
            s = s.replace(rho=s.rho.at[row].set(rho))
        return al[:i] + (s,) + al[i + 1 :]

    def get_penalty(self, al: ALState, family, knot=None):
        """Penalty of one constraint family (`al_cost.hpp:171-200`):
        the [nk] per-knot vector, or the scalar at `knot`."""
        i = self._family_index(family)
        rho = al[i].rho
        if knot is None:
            return rho
        row = _knot_row(self.prob.constraint_families[i], knot)
        return rho[row]

    def get_duals(self, al: ALState, family, knot=None):
        """Lagrange multipliers of one family (`al_cost.hpp:204-231`
        analog): [nk, p], or the [p] row at `knot`."""
        i = self._family_index(family)
        lam = al[i].lam
        if knot is None:
            return lam
        row = _knot_row(self.prob.constraint_families[i], knot)
        return lam[row]

    def reset_duals(self, al: ALState) -> ALState:
        return tuple(s.replace(lam=jnp.zeros_like(s.lam)) for s in al)

    # ------------------------------------------------------------------- costs
    def cost_terms(self, params: ProblemParams, al: ALState, Z: Trajectory):
        """Per-knot total cost (base + AL penalty), [N+1].

        Matches `iLQR::CalcIndividualCosts` with an `ALCost` at each knot
        (`ilqr.hpp:758-763`, `al_cost.hpp:264-274`).
        """
        X, U = Z.X, Z.upad()
        costs = jnp.zeros(self.prob.N + 1, X.dtype)
        for fam, fp in zip(self.prob.cost_families, params.costs):
            vals = _vmap_family(fam, fp, fam.fn, X, U)
            costs = costs.at[fam.knots].add(vals)
        for fam, fp, state in zip(
            self.prob.constraint_families, params.constraints, al
        ):
            c = _vmap_family(fam, fp, fam.fn, X, U)  # [nk, p]
            costs = costs.at[fam.knots].add(_al_value(fam.cone, c, state))
        return costs

    def total_cost(self, params, al, Z):
        return self.cost_terms(params, al, Z).sum()

    # -------------------------------------------------------------- expansions
    def expand(self, params: ProblemParams, al: ALState, Z: Trajectory) -> Expansions:
        """Cost + dynamics expansions for every knot, one batched kernel per
        family (`ilqr.hpp:670-677` is the per-knot serial analog)."""
        prob = self.prob
        N, n, m = prob.N, prob.n, prob.m
        X, U = Z.X, Z.upad()
        dt = X.dtype
        costs = jnp.zeros(N + 1, dt)
        lx = jnp.zeros((N + 1, n), dt)
        lu = jnp.zeros((N + 1, m), dt)
        lxx = jnp.zeros((N + 1, n, n), dt)
        lxu = jnp.zeros((N + 1, n, m), dt)
        luu = jnp.zeros((N + 1, m, m), dt)

        for fam, fp in zip(prob.cost_families, params.costs):
            expand_fn = fam.expand_fn
            if expand_fn is None:
                from ..problem.costs import ad_expansion

                expand_fn = lambda p, x, u, _fn=fam.fn: ad_expansion(_fn, p, x, u)
            terms: CostExpansionTerms = _vmap_family(fam, fp, expand_fn, X, U)
            ks = fam.knots
            costs = costs.at[ks].add(terms.J)
            lx = lx.at[ks].add(terms.lx)
            lu = lu.at[ks].add(terms.lu)
            lxx = lxx.at[ks].add(terms.lxx)
            lxu = lxu.at[ks].add(terms.lxu)
            luu = luu.at[ks].add(terms.luu)

        for fam, fp, state in zip(prob.constraint_families, params.constraints, al):
            J, gx, gu, Hxx, Hxu, Huu = self._al_family_expansion(
                fam, fp, state, X, U
            )
            ks = fam.knots
            costs = costs.at[ks].add(J)
            lx = lx.at[ks].add(gx)
            lu = lu.at[ks].add(gu)
            lxx = lxx.at[ks].add(Hxx)
            lxu = lxu.at[ks].add(Hxu)
            luu = luu.at[ks].add(Huu)

        A, B = self._dynamics_expansion(params, Z)
        return Expansions(
            costs=costs, lx=lx, lu=lu, lxx=lxx, lxu=lxu, luu=luu, A=A, B=B
        )

    def _al_family_expansion(self, fam, fp, state: ConState, X, U):
        """AL value/gradient/Gauss-Newton-Hessian for one constraint family.

        Implements `ConstraintValues::AugLag/AugLagGradient/AugLagHessian`
        (`constraint_values.hpp:111-177`) with diagonal projection Jacobians.
        """
        dual = dual_cone(fam.cone)

        def jac_fn(p, x, u):
            if fam.jac_fn is not None:
                return fam.jac_fn(p, x, u)
            return jax.jacfwd(fam.fn, argnums=(1, 2))(p, x, u)

        from ..problem.constraints import cone_is_diagonal, cone_jacobian

        def one(p, x, u, lam, rho):
            c = fam.fn(p, x, u)
            Cx, Cu = jac_fn(p, x, u)
            s = lam - rho * c
            lam_proj = cone_project(dual, s)
            J = (lam_proj @ lam_proj - lam @ lam) / (2.0 * rho)
            if cone_is_diagonal(dual):
                dproj = cone_jacobian_diag(dual, s)
                Jpx = dproj[:, None] * Cx
                Jpu = dproj[:, None] * Cu
            else:
                Jp = cone_jacobian(dual, s)
                Jpx = Jp @ Cx
                Jpu = Jp @ Cu
            gx = -(Jpx.T @ lam_proj)
            gu = -(Jpu.T @ lam_proj)
            Hxx = rho * (Jpx.T @ Jpx)
            Hxu = rho * (Jpx.T @ Jpu)
            Huu = rho * (Jpu.T @ Jpu)
            return J, gx, gu, Hxx, Hxu, Huu

        ks = fam.knots
        if fam.shared:
            return jax.vmap(lambda x, u, l, r: one(fp, x, u, l, r))(
                X[ks], U[ks], state.lam, state.rho
            )
        return jax.vmap(one)(fp, X[ks], U[ks], state.lam, state.rho)

    def _dynamics_expansion(self, params: ProblemParams, Z: Trajectory):
        """Discrete Jacobians A [N,n,n], B [N,n,m] via vmapped AD
        (`dynamics_expansion.hpp:42-47` + `integration.hpp:132-169`)."""
        prob = self.prob
        N, n, m = prob.N, prob.n, prob.m
        dt = Z.X.dtype
        A = jnp.zeros((N, n, n), dt)
        B = jnp.zeros((N, n, m), dt)
        for fam, fp in zip(prob.dynamics_families, params.dynamics):
            ks = fam.knots

            def jac(p, x, u, t, h):
                if fam.jac_fn is not None:
                    return fam.jac_fn(p, x, u, t, h)
                return jax.jacfwd(fam.fn, argnums=(1, 2))(p, x, u, t, h)

            if fam.shared:
                Af, Bf = jax.vmap(lambda x, u, t, h: jac(fp, x, u, t, h))(
                    Z.X[ks], Z.U[ks], Z.t[ks], Z.h[ks]
                )
            else:
                Af, Bf = jax.vmap(jac)(fp, Z.X[ks], Z.U[ks], Z.t[ks], Z.h[ks])
            A = A.at[ks].set(Af)
            B = B.at[ks].set(Bf)
        return A, B

    # ------------------------------------------------------------- constraints
    def constraint_values(self, params: ProblemParams, Z: Trajectory):
        """Constraint values per family, tuple of [nk, p]."""
        X, U = Z.X, Z.upad()
        return tuple(
            _vmap_family(fam, fp, fam.fn, X, U)
            for fam, fp in zip(self.prob.constraint_families, params.constraints)
        )

    def max_violation(self, cvals) -> jax.Array:
        """∞-norm violation over all constraints and knots
        (`al_solver.hpp:417-424`)."""
        viol = jnp.zeros((), self._dtype(cvals))
        for fam, c in zip(self.prob.constraint_families, cvals):
            viol = jnp.maximum(viol, cone_violation(fam.cone, c).max())
        return viol

    def max_penalty(self, al: ALState) -> jax.Array:
        """Max penalty across constraints (`al_solver.hpp:427-434`)."""
        pen = jnp.zeros(())
        for s in al:
            pen = jnp.maximum(pen, s.rho.max())
        return pen

    def update_duals(self, al: ALState, cvals) -> ALState:
        """λ ← Π_{K*}(λ − ρ∘c) (`constraint_values.hpp:192-194`)."""
        out = []
        for fam, s, c in zip(self.prob.constraint_families, al, cvals):
            dual = dual_cone(fam.cone)
            lam = cone_project_rows(dual, s.lam - s.rho[:, None] * c)
            out.append(s.replace(lam=lam))
        return tuple(out)

    def update_penalties(self, al: ALState) -> ALState:
        """ρ ← φρ geometric increase (`constraint_values.hpp:202-207`)."""
        phi = self.opts.penalty_scaling
        return tuple(s.replace(rho=s.rho * phi) for s in al)

    def _dtype(self, cvals):
        for c in cvals:
            return c.dtype
        return jnp.zeros(0).dtype

    # ---------------------------------------------------------------- rollouts
    def rollout(self, params: ProblemParams, Z: Trajectory) -> Trajectory:
        """Open-loop rollout from the problem's initial state
        (`ilqr.hpp:453-459`)."""
        prob = self.prob
        x0 = jnp.asarray(params.x0, Z.X.dtype)

        def step(x, inp):
            k, u, t, h = inp
            xn = prob.dynamics_step(params.dynamics, k, x, u, t, h)
            return xn, xn

        ks = jnp.arange(prob.N)
        _, Xnext = jax.lax.scan(step, x0, (ks, Z.U, Z.t[:-1], Z.h))
        X = jnp.concatenate([x0[None], Xnext], axis=0)
        return Z.replace(X=X)
